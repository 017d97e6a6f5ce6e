"""Training CLI of the port: `python -m dust3r_tpu_torch.train`.

The root `train.py`'s flags (the reference's), driving
`dust3r_tpu_torch.training.train` on the CUDA card (`--device cpu` for the
CPU). `--mesh N` trains data-parallel, one process a card
(`DistributedDataParallel` over `--dist_backend`, nccl by default):

    python -m dust3r_tpu_torch.train --mesh 4 ...                    # starts 4 ranks
    torchrun --nproc_per_node 4 -m dust3r_tpu_torch.train --mesh 4 ...  # the launcher's

`--mesh N,F[,M]` with F or M above 1 (parameter sharding, the tensor-parallel
MLP) raises (ROADMAP.md A10b); `--scan_layers` is an XLA compile-time option
with no effect here; `--remat_policy` takes 'full' only.
"""
import argparse


def get_args_parser():
    parser = argparse.ArgumentParser("DUSt3R training (PyTorch port)", add_help=False)
    parser.add_argument(
        "--model",
        default="AsymmetricCroCo3DStereo(pos_embed='RoPE100', img_size=(224, 224), "
                "head_type='linear', output_mode='pts3d', depth_mode=('exp', -inf, inf), "
                "conf_mode=('exp', 1, inf), enc_embed_dim=1024, enc_depth=24, "
                "enc_num_heads=16, dec_embed_dim=768, dec_depth=12, dec_num_heads=12)",
        type=str, help="model architecture string")
    parser.add_argument("--pretrained", default=None,
                        help="path of a starting checkpoint (.pth)")
    parser.add_argument("--train_criterion",
                        default="ConfLoss(Regr3D(L21, norm_mode='avg_dis'), alpha=0.2)",
                        type=str, help="train criterion")
    parser.add_argument("--test_criterion", default=None, type=str)
    parser.add_argument("--train_dataset", required=True, type=str)
    parser.add_argument("--test_dataset", default="[None]", type=str)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--batch_size", default=64, type=int)
    parser.add_argument("--accum_iter", default=1, type=int)
    parser.add_argument("--epochs", default=800, type=int)
    parser.add_argument("--weight_decay", type=float, default=0.05)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--blr", type=float, default=1.5e-4)
    parser.add_argument("--min_lr", type=float, default=0.0)
    parser.add_argument("--warmup_epochs", type=int, default=40)
    parser.add_argument("--amp", type=int, default=0, choices=[0, 1],
                        help="bf16 compute in the model body")
    parser.add_argument("--scan_layers", type=int, default=0, choices=[0, 1],
                        help="accepted for the JAX CLI's sake: an XLA compile option, no "
                             "effect in the port")
    parser.add_argument("--remat", type=int, default=0, choices=[0, 1],
                        help="recompute each block's activations in the backward "
                             "(activation checkpointing: less memory, more time)")
    parser.add_argument("--remat_policy", type=str, default="full", choices=["full", "dots"],
                        help="'full' only: 'dots' is an XLA checkpoint policy and raises")
    parser.add_argument("--num_workers", default=8, type=int)
    parser.add_argument("--mesh", default="", type=str,
                        help="data-parallel ranks, one a card: 'N' or 'auto' (every visible "
                             "card); 'N,F[,M]' with F or M > 1 is not ported (A10b)")
    parser.add_argument("--dist_backend", default="nccl", type=str, choices=["nccl", "gloo"],
                        help="torch.distributed backend of --mesh: nccl on the cards, gloo on "
                             "the CPU or for several ranks on one card")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device; default: the CUDA card")
    parser.add_argument("--world_size", default=1, type=int,
                        help="the ranks the run expects: a launcher that started another "
                             "number is refused (1: any)")
    parser.add_argument("--local_rank", default=-1, type=int,
                        help="this rank's card where LOCAL_RANK is unset (the flag of "
                             "torch.distributed.launch)")
    parser.add_argument("--dist_url", default="env://", type=str, help="accepted; unused")
    parser.add_argument("--disable_cudnn_benchmark", action="store_true", default=False,
                        help="accepted; unused")
    parser.add_argument("--eval_freq", type=int, default=1)
    parser.add_argument("--save_freq", default=1, type=int)
    parser.add_argument("--keep_freq", default=20, type=int)
    parser.add_argument("--print_freq", default=20, type=int)
    parser.add_argument("--output_dir", default="./output/", type=str)
    return parser


def main(argv=None):
    from .training import train

    train(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()

"""Checkpoint I/O: the reference's `.pth` files, hub snapshots, and the
bridge from JAX (flax) parameter trees.

Counterpart of `dust3r_tpu/checkpoint.py`'s loaders, on torch tensors under
their own names (no flax tree in between):

* `parse_arch_string` / `model_from_arch_string`: the reference's
  `args.model` string, parsed with `ast` (never `eval`);
* `model_from_hub_config`: a hub mixin's `config.json` (JSON-mangled
  infinities restored, nested `croco_kwargs` flattened, keys the
  constructor does not take dropped);
* `load_torch_checkpoint` (a `{args | arch, model}` `.pth`),
  `load_hub_checkpoint` (`model.safetensors`, a legacy `pytorch_model.bin`,
  a `.bin` that is a full reference checkpoint, a training-style
  `{model: sd}` wrapper) and `from_pretrained` (a file, a snapshot
  directory, or a hub repo id through `huggingface_hub`), each returning
  the loaded module;
* `save_torch_checkpoint`: `{"arch": <string>, "model": state_dict}`;
* training's: `save_train_checkpoint` / `load_train_checkpoint` (the
  reference's `checkpoint-{last,best,final,N}.pth`: `model`, `optimizer`,
  `epoch`, `best_so_far`, `args`; `load_torch_checkpoint` reads it) and
  `warm_start` (`--pretrained`: a full DUSt3R `.pth` or a backbone-only
  one over the model's init, missing parts left as they are, the JAX
  `warm_start_params` / `overlay_params`).

The tensors go through what `convert_torch_state_dict` does to them
(`convert_state_dict`): `dec_blocks.*` copied into `dec_blocks2.*` when a
checkpoint holds one decoder, bf16 upcast to fp32, the `scratch.layer_rn.{k}`
spelling of the DPT reassembly convs renamed, and the tensors the JAX
converter leaves unconsumed (`mask_token`, rope buffers, ...) dropped, with
the dead `refinenet4.resConfUnit1` the port does not build; then
`load_state_dict(strict=True)`. Constructor overrides (`dtype`,
`head_dtype`, `device`, `attn_impl`, `conv_impl`) pass through, as the JAX
loaders' overrides do; with no `device` the model lands on
the CUDA card (it raises without one: pass device="cpu").

`landscape_only` is taken and not used, as the JAX model only stores it:
per-sample `is_portrait` flags choose the ManyAR path. One deliberate
divergence from the JAX loaders: an orbax directory raises, since it holds
JAX trees the port cannot read without JAX (and training writes `.pth`
files where JAX writes orbax directories).

`state_dict_from_jax` reproduces `dust3r_tpu/checkpoint.py::to_torch_state_dict`
name for name, in numpy: Dense `kernel.T` becomes `weight`; conv HWIO
becomes OIHW; the `_PatchExpand` kernel (in, out, s, s) is already the
`ConvTranspose2d` layout; LayerNorm `ln.scale` / `ln.bias` become `weight` /
`bias`. A flax DPT init has no `refinenet4.resConfUnit1` (that unit never
receives an input) and the port does not build one; a tree converted from
torch does carry it, and the bridge drops it. A tree quantized by the JAX
`quantize_params` carries its QuantDense leaves (`kernel_q` (K, N) int8,
`kernel_scale`, `bias`) into a quantized port module's `weight_q` (N, K)
int8, `weight_scale` and `bias`.
"""
from __future__ import annotations

import ast
import inspect
import json
import math
import os
import re

import numpy as np
import torch
import torch.distributed as dist

# what the port's constructor takes from an arch string or a hub config;
# the rest of its arguments (dtype, device, ...) are the caller's overrides
_OVERRIDES = ("dtype", "head_dtype", "attn_impl", "conv_impl", "device", "seed", "remat",
              "remat_policy")
_HUB_WEIGHT_NAMES = ("model.safetensors", "pytorch_model.bin")
# the DPT head's dead unit: real checkpoints carry it, nothing reads it
_DEAD_UNIT = re.compile(r"^downstream_head[12]\.dpt\.scratch\.refinenet4\.resConfUnit1\.")
_LAYER_RN = re.compile(r"^(downstream_head[12]\.dpt\.scratch)\.layer_rn\.(\d+)\.")


# ---------------------------------------------------------------------- #
# architecture strings and hub configs
# ---------------------------------------------------------------------- #

def parse_arch_string(arch):
    """'AsymmetricCroCo3DStereo(a=1, b=(2, 3), ...)' -> kwargs dict.

    The reference evals this string (dust3r/model.py:27-43); here it is
    parsed: constants, tuples, lists, unary minus, `inf` and `float(...)`.
    `patch_embed_cls` is dropped (one patch embed)."""
    m = re.match(r"\s*(\w+)\((.*)\)\s*$", arch, re.S)
    if not m:
        raise ValueError(f"cannot parse arch string: {arch!r}")
    name, argstr = m.groups()
    if name != "AsymmetricCroCo3DStereo":
        raise ValueError(f"unknown architecture {name}")
    argstr = re.sub(r"(?<![\w.])inf(?![\w.])", "float('inf')", argstr)
    tree = ast.parse(f"dict({argstr})", mode="eval")

    def ev(node):
        if isinstance(node, ast.Call):
            if getattr(node.func, "id", None) == "dict":
                return {kw.arg: ev(kw.value) for kw in node.keywords}
            if getattr(node.func, "id", None) == "float":
                return float(ev(node.args[0]))
            raise ValueError(f"unsupported call in arch string: {ast.dump(node)}")
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Tuple):
            return tuple(ev(e) for e in node.elts)
        if isinstance(node, ast.List):
            return [ev(e) for e in node.elts]
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev(node.operand)
        if isinstance(node, ast.Name) and node.id == "inf":
            return math.inf
        raise ValueError(f"unsupported node in arch string: {ast.dump(node)}")

    kwargs = ev(tree.body)
    kwargs.pop("patch_embed_cls", None)
    return kwargs


def _build(kwargs, landscape_only, overrides):
    """The module of `kwargs` and `overrides`. landscape_only (the loaders'
    argument, and the key of an arch string or a config) is taken and
    dropped: the model is the same either way, as in JAX."""
    from .models.model import AsymmetricCroCo3DStereo

    kwargs.pop("landscape_only", None)
    kwargs.update(overrides)
    if isinstance(kwargs.get("img_size"), int):
        kwargs["img_size"] = (kwargs["img_size"], kwargs["img_size"])
    return AsymmetricCroCo3DStereo(**kwargs)


def model_from_arch_string(arch, landscape_only=False, **overrides):
    """The module an arch string describes, with random weights."""
    return _build(parse_arch_string(arch), landscape_only, overrides)


def model_from_hub_config(cfg, landscape_only=False, **overrides):
    """The module a hub mixin's `config.json` dict describes (the
    reference's `__init__` kwargs, dust3r/model.py:47-52), with random
    weights."""
    from .models.model import AsymmetricCroCo3DStereo

    cfg = dict(cfg)
    nested = cfg.pop("croco_kwargs", None)  # some mixin versions group them
    if isinstance(nested, dict):
        cfg.update(nested)
    taken = set(inspect.signature(AsymmetricCroCo3DStereo.__init__).parameters)
    taken -= {"self", *_OVERRIDES}

    def fix_inf(x):
        if isinstance(x, str) and x.lstrip("+-") in ("inf", "Infinity"):
            return -math.inf if x.startswith("-") else math.inf
        return x

    kwargs = {}
    for k, v in cfg.items():
        if k not in taken:
            continue
        if isinstance(v, (list, tuple)):
            v = tuple(fix_inf(x) for x in v)
        kwargs[k] = v
    return _build(kwargs, landscape_only, overrides)


def arch_string(model):
    """The reference's `args.model` string of a port module (the fields
    `dust3r_tpu.checkpoint.save_torch_checkpoint` writes)."""
    conf = tuple(model.conf_mode) if model.conf_mode else None
    return (f"AsymmetricCroCo3DStereo(pos_embed={model.pos_embed!r}, "
            f"img_size={tuple(model.img_size)}, patch_size={model.patch_size}, "
            f"head_type={model.head_type!r}, output_mode={model.output_mode!r}, "
            f"depth_mode={tuple(model.depth_mode)}, conf_mode={conf}, "
            f"enc_embed_dim={model.enc_embed_dim}, enc_depth={model.enc_depth}, "
            f"enc_num_heads={model.enc_num_heads}, dec_embed_dim={model.dec_embed_dim}, "
            f"dec_depth={model.dec_depth}, dec_num_heads={model.dec_num_heads}, "
            f"mlp_ratio={model.mlp_ratio})")


# ---------------------------------------------------------------------- #
# state dicts
# ---------------------------------------------------------------------- #

def convert_state_dict(sd, model_keys, verbose=False):
    """A checkpoint's {name: tensor} -> the tensors the port's module takes
    (names in `model_keys`), as the JAX converter reads them: a single
    decoder copied into `dec_blocks2`, bf16 upcast to fp32,
    `scratch.layer_rn.{k-1}` renamed `scratch.layer{k}_rn`. Tensors the
    module does not take are dropped; with `verbose` those the JAX
    converter leaves unconsumed too are reported as it reports them (the
    dead `refinenet4.resConfUnit1`, which it does read, is dropped
    quietly)."""
    sd = {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in sd.items()}
    sd = {_LAYER_RN.sub(lambda m: f"{m[1]}.layer{int(m[2]) + 1}_rn.", k): v
          for k, v in sd.items()}
    if not any(k.startswith("dec_blocks2") for k in sd):
        sd.update({"dec_blocks2." + k[len("dec_blocks."):]: v for k, v in sd.items()
                   if k.startswith("dec_blocks.")})
    model_keys = set(model_keys)
    if verbose:
        leftovers = sorted(k for k in sd if k not in model_keys and not _DEAD_UNIT.match(k)
                           and not k.endswith("num_batches_tracked"))
        if leftovers:
            print(f"converter: {len(leftovers)} unused checkpoint tensors "
                  f"(expected for mask_token/rope buffers): {leftovers[:10]}"
                  + (" ..." if len(leftovers) > 10 else ""))
    return {k: v for k, v in sd.items() if k in model_keys}


def _load_weights(model, sd, verbose):
    model.load_state_dict(convert_state_dict(sd, model.state_dict().keys(), verbose),
                          strict=True)
    return model


def _load_wrapped_ckpt(ckpt, verbose=True, landscape_only=False, **overrides):
    """An already-loaded {args | arch, model} checkpoint -> the module."""
    args = ckpt.get("args", None)
    arch = args.model if hasattr(args, "model") else ckpt.get("arch")
    if not arch:
        raise ValueError("checkpoint missing architecture string")
    if verbose:
        print(f"instantiating from arch string: {arch}")
    model = model_from_arch_string(arch, landscape_only, **overrides)
    return _load_weights(model, ckpt["model"], verbose)


def load_torch_checkpoint(path, verbose=True, landscape_only=False, **overrides):
    """A reference `.pth` ({args | arch, model}) -> the loaded module (the
    reference's load_model, dust3r/model.py:27-43, with the arch string
    parsed)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
    return _load_wrapped_ckpt(ckpt, verbose, landscape_only, **overrides)


def load_hub_checkpoint(weights_path, config_path=None, verbose=True, landscape_only=False,
                        **overrides):
    """A hub mixin snapshot -> the loaded module. The weights are a bare
    state dict (`model.safetensors`, or `pytorch_model.bin` in older
    snapshots) with the architecture in `config.json`; a `.bin` that is a
    full reference checkpoint goes through its arch string, and a
    training-style {model: sd, ...} wrapper gives its inner state dict."""
    if weights_path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(weights_path)
    else:
        ckpt = torch.load(weights_path, map_location="cpu", weights_only=False, mmap=True)
        if isinstance(ckpt, dict) and "model" in ckpt and ("args" in ckpt or "arch" in ckpt):
            return _load_wrapped_ckpt(ckpt, verbose, landscape_only, **overrides)
        sd = ckpt["model"] if isinstance(ckpt, dict) and isinstance(ckpt.get("model"),
                                                                    dict) else ckpt
    if not config_path:
        raise ValueError("hub checkpoint has no architecture string; config.json required")
    with open(config_path) as f:
        cfg = json.load(f)
    if verbose:
        print(f"instantiating from hub config: {config_path}")
    model = model_from_hub_config(cfg, landscape_only, **overrides)
    return _load_weights(model, sd, verbose)


def _sibling_config(path):
    cpath = os.path.join(os.path.dirname(os.path.abspath(path)), "config.json")
    return cpath if os.path.isfile(cpath) else None


def from_pretrained(name_or_path, verbose=True, **overrides):
    """A local `.pth`, a hub snapshot (file or directory), or a hub repo id
    (downloaded through `huggingface_hub`) -> the loaded module. A sibling
    `config.json` is read only next to hub-named weights, so an unrelated
    neighbour cannot define the architecture."""
    if os.path.isfile(name_or_path):
        if name_or_path.endswith(".safetensors") or \
                os.path.basename(name_or_path) in _HUB_WEIGHT_NAMES:
            return load_hub_checkpoint(name_or_path, _sibling_config(name_or_path),
                                       verbose=verbose, **overrides)
        return load_torch_checkpoint(name_or_path, verbose=verbose, **overrides)
    if os.path.isdir(name_or_path):
        for name in _HUB_WEIGHT_NAMES:
            wpath = os.path.join(name_or_path, name)
            if os.path.isfile(wpath):
                return load_hub_checkpoint(wpath, _sibling_config(wpath), verbose=verbose,
                                           **overrides)
        raise NotImplementedError(
            f"{name_or_path} holds no {' or '.join(_HUB_WEIGHT_NAMES)}: an orbax checkpoint "
            f"directory holds JAX trees the port cannot read without JAX. Export it with "
            f"dust3r_tpu.checkpoint.save_torch_checkpoint and load that .pth")
    from huggingface_hub import hf_hub_download
    from huggingface_hub.utils import EntryNotFoundError

    try:
        wpath = hf_hub_download(repo_id=name_or_path, filename="model.safetensors")
    except EntryNotFoundError:
        wpath = hf_hub_download(repo_id=name_or_path, filename="pytorch_model.bin")
    try:
        cpath = hf_hub_download(repo_id=name_or_path, filename="config.json")
    except EntryNotFoundError:
        cpath = None
    return load_hub_checkpoint(wpath, cpath, verbose=verbose, **overrides)


def save_torch_checkpoint(path, model, extra=None):
    """Write {"arch": <string>, "model": state_dict} (host fp32 tensors),
    loadable by this module's loaders and the JAX package's."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(dict(arch=arch_string(model), model=sd, **(extra or {})), path)


# ---------------------------------------------------------------------- #
# training
# ---------------------------------------------------------------------- #

def save_train_checkpoint(path, model, optimizer, epoch, best_so_far, args, state=None):
    """The reference's training checkpoint: {model, optimizer, epoch,
    best_so_far, args}, host tensors. `args.model` is the arch string, so
    `load_torch_checkpoint` / `load_model` read the file. state: the
    (model, optimizer) state dicts `full_train_state` gathered from a
    sharded model, else those of `model` and `optimizer`."""
    if state is None:
        state = ({k: v.detach().cpu() for k, v in model.state_dict().items()},
                 optimizer.state_dict())
    torch.save(dict(model=state[0], optimizer=state[1], epoch=epoch, best_so_far=best_so_far,
                    args=args), path)


def _sharded_entries(model, optimizer):
    """The tensors of a sharded model's and its optimizer's state in one
    order, the same on every rank: ("model", name, tensor) for each
    `state_dict` entry, ("optimizer", index, key, tensor) for each AdamW
    state tensor, the index that of `optimizer.state_dict()` (the order of
    the parameter groups, as `--mesh 1` numbers them)."""
    for name, t in model.state_dict().items():
        yield ("model", name), t
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        for key, t in sorted(optimizer.state.get(p, {}).items()):
            if isinstance(t, torch.Tensor):
                yield ("optimizer", i, key), t


def full_train_state(model, optimizer):
    """(model state dict, optimizer state dict) of a model sharded by
    `parallel.mesh.shard_params`, whole and on the host, in the layout
    `--mesh 1` writes (`model.state_dict()` and `optimizer.state_dict()` of
    the unsharded model: the same keys, shapes and numbering) on rank 0;
    (None, None) on the other ranks. A collective: every rank calls it."""
    from .parallel.mesh import full_tensor

    mesh = model.train_mesh
    osd = optimizer.state_dict()  # its state dicts are the optimizer's own: copied
    model_sd, state = {}, {i: dict(st) for i, st in osd["state"].items()}
    for where, t in _sharded_entries(model, optimizer):
        whole = full_tensor(t, mesh)
        if whole is None:
            continue
        if where[0] == "model":
            model_sd[where[1]] = whole
        else:
            state[where[1]][where[2]] = whole
    if dist.get_rank() != 0:
        return None, None
    return model_sd, dict(state=state, param_groups=osd["param_groups"])


def load_train_checkpoint(path, model, optimizer):
    """Resume from a `save_train_checkpoint` file: the weights and the
    optimizer state in place; returns (epoch, best_so_far). A model sharded
    by `parallel.mesh.shard_params` reads the `--mesh 1` layout from rank
    0, which broadcasts each tensor; every rank keeps its shards (a
    collective: every rank calls it)."""
    mesh = getattr(model, "train_mesh", None)
    if mesh is None:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        model.load_state_dict(ckpt["model"], strict=True)
        optimizer.load_state_dict(ckpt["optimizer"])
        return ckpt.get("epoch", -1), ckpt.get("best_so_far", math.inf)
    return _load_sharded(path, model, optimizer, mesh)


def _load_sharded(path, model, optimizer, mesh):
    from .parallel.mesh import load_full

    ckpt = torch.load(path, map_location="cpu", weights_only=False) if dist.get_rank() == 0 \
        else None
    head = [None]
    if ckpt is not None:
        osd = ckpt["optimizer"]
        head[0] = dict(epoch=ckpt.get("epoch", -1), best=ckpt.get("best_so_far", math.inf),
                       keys=sorted(ckpt["model"]), param_groups=osd["param_groups"],
                       state={i: {k: (tuple(v.shape) if isinstance(v, torch.Tensor) else v)
                                  for k, v in st.items()} for i, st in osd["state"].items()})
    dist.broadcast_object_list(head, 0)
    head = head[0]
    own = model.state_dict()
    if head["keys"] != sorted(own):
        missing, extra = set(own) - set(head["keys"]), set(head["keys"]) - set(own)
        raise KeyError(f"{path}: missing {sorted(missing)[:5]}, unexpected {sorted(extra)[:5]}")
    for name, t in own.items():
        load_full(t, ckpt["model"][name] if ckpt is not None else None, mesh)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i, entry in sorted(head["state"].items()):
        p, st = params[i], {}
        for key, v in sorted(entry.items()):
            if not isinstance(v, tuple):
                st[key] = v
            elif v == tuple(p.shape):  # a moment: sharded as its parameter
                st[key] = torch.empty_like(p)
                load_full(st[key], ckpt["optimizer"]["state"][i][key] if ckpt is not None
                          else None, mesh)
            else:  # the step count: every rank's whole
                st[key] = torch.empty(v)
                load_full(st[key], ckpt["optimizer"]["state"][i][key] if ckpt is not None
                          else None, mesh)
        state[i] = st
    optimizer.load_state_dict(dict(state=state, param_groups=head["param_groups"]))
    return head["epoch"], head["best"]


def warm_start(path, model, verbose=True):
    """Training's `--pretrained`: a torch `.pth` (a full DUSt3R checkpoint,
    or a backbone-only one such as CroCo's) over the model's init. The
    architecture is the model's (`--model`), not the file's; the file's
    tensors, as `convert_state_dict` reads them, replace the model's where
    they exist, the rest keep their init (the JAX `warm_start_params` /
    `overlay_params`). A shape that differs raises."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    own = model.state_dict()
    converted = convert_state_dict(sd, own.keys(), verbose)
    for k, v in converted.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch for {k}: checkpoint {tuple(v.shape)} vs "
                             f"model {tuple(own[k].shape)}")
    model.load_state_dict(converted, strict=False)
    if verbose:
        print(f"warm start: {len(converted)} of {len(own)} tensors from {path}")
    return model


# ---------------------------------------------------------------------- #
# the JAX bridge
# ---------------------------------------------------------------------- #

def unstack_scan_params(variables, enc_depth, dec_depth):
    """A `scan_layers=True` tree (blocks stacked on a leading depth axis in
    `enc_blocks_scan/block` and `dec_blocks_scan/block1|block2`) -> the
    per-layer tree; the JAX `checkpoint.unstack_scan_params`, on numpy."""
    params = dict(variables["params"])
    enc = params.pop("enc_blocks_scan")["block"]
    dec = params.pop("dec_blocks_scan")

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else np.asarray(v)[i]
                for k, v in tree.items()}

    for i in range(enc_depth):
        params[f"enc_blocks_{i}"] = layer(enc, i)
    for i in range(dec_depth):
        params[f"dec_blocks_{i}"] = layer(dec["block1"], i)
        params[f"dec_blocks2_{i}"] = layer(dec["block2"], i)
    return {"params": params}


def state_dict_from_jax(variables, enc_depth=24, dec_depth=12, head_type="linear"):
    """flax `{"params": ...}` tree with numpy leaves -> {name: tensor}: fp32,
    and int8 for the `weight_q` of a quantized tree's QuantDense leaves. A
    `scan_layers=True` tree is unstacked first, as JAX's exporter does."""
    if "enc_blocks_scan" in variables["params"]:
        variables = unstack_scan_params(variables, enc_depth, dec_depth)
    params = variables["params"]
    sd = {}

    def node(path):
        out = params
        for key in path:
            out = out[key]
        return out

    def get(path):
        return np.asarray(node(path))

    def linear(t, f):
        if "kernel_q" in node(f):  # QuantDense (dust3r_tpu/ops/quant.py)
            sd[t + ".weight_q"] = get(f + ("kernel_q",)).T
            sd[t + ".weight_scale"] = get(f + ("kernel_scale",))
            sd[t + ".bias"] = get(f + ("bias",))
            return
        sd[t + ".weight"] = get(f + ("kernel",)).T
        if "bias" in node(f):
            sd[t + ".bias"] = get(f + ("bias",))

    def conv(t, f, bias=True):
        sd[t + ".weight"] = get(f + ("kernel",)).transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if bias:
            sd[t + ".bias"] = get(f + ("bias",))

    def conv_t(t, f):
        sd[t + ".weight"] = get(f + ("kernel",))
        sd[t + ".bias"] = get(f + ("bias",))

    def ln(t, f):
        sd[t + ".weight"] = get(f + ("ln", "scale"))
        sd[t + ".bias"] = get(f + ("ln", "bias"))

    def block(t, f):
        ln(f"{t}.norm1", f + ("norm1",))
        linear(f"{t}.attn.qkv", f + ("attn", "qkv"))
        linear(f"{t}.attn.proj", f + ("attn", "proj"))
        ln(f"{t}.norm2", f + ("norm2",))
        linear(f"{t}.mlp.fc1", f + ("mlp", "fc1"))
        linear(f"{t}.mlp.fc2", f + ("mlp", "fc2"))

    def dec_block(t, f):
        ln(f"{t}.norm1", f + ("norm1",))
        linear(f"{t}.attn.qkv", f + ("attn", "qkv"))
        linear(f"{t}.attn.proj", f + ("attn", "proj"))
        ln(f"{t}.norm_y", f + ("norm_y",))
        ln(f"{t}.norm2", f + ("norm2",))
        for p in ("projq", "projk", "projv", "proj"):
            linear(f"{t}.cross_attn.{p}", f + ("cross_attn", p))
        ln(f"{t}.norm3", f + ("norm3",))
        linear(f"{t}.mlp.fc1", f + ("mlp", "fc1"))
        linear(f"{t}.mlp.fc2", f + ("mlp", "fc2"))

    def dpt_head(t, f):
        conv(f"{t}.dpt.act_postprocess.0.0", f + ("act_0_proj",))
        conv_t(f"{t}.dpt.act_postprocess.0.1", f + ("act_0_up4",))
        conv(f"{t}.dpt.act_postprocess.1.0", f + ("act_1_proj",))
        conv_t(f"{t}.dpt.act_postprocess.1.1", f + ("act_1_up2",))
        conv(f"{t}.dpt.act_postprocess.2.0", f + ("act_2_proj",))
        conv(f"{t}.dpt.act_postprocess.3.0", f + ("act_3_proj",))
        conv(f"{t}.dpt.act_postprocess.3.1", f + ("act_3_down2",))
        for k in range(1, 5):
            conv(f"{t}.dpt.scratch.layer{k}_rn", f + (f"layer{k}_rn",), bias=False)
            rf = f"{t}.dpt.scratch.refinenet{k}"
            # refinenet4's resConfUnit1 is dead weight: dropped if present
            units = ("resConfUnit2",) if k == 4 else ("resConfUnit1", "resConfUnit2")
            for unit in units:
                for c in ("conv1", "conv2"):
                    conv(f"{rf}.{unit}.{c}", f + (f"refinenet{k}", unit, c))
            conv(f"{rf}.out_conv", f + (f"refinenet{k}", "out_conv"))
        conv(f"{t}.dpt.head.0", f + ("head_conv1",))
        conv(f"{t}.dpt.head.2", f + ("head_conv2",))
        conv(f"{t}.dpt.head.4", f + ("head_conv3",))

    conv("patch_embed.proj", ("patch_embed", "proj"))
    for i in range(enc_depth):
        block(f"enc_blocks.{i}", (f"enc_blocks_{i}",))
    ln("enc_norm", ("enc_norm",))
    linear("decoder_embed", ("decoder_embed",))
    for i in range(dec_depth):
        dec_block(f"dec_blocks.{i}", (f"dec_blocks_{i}",))
        dec_block(f"dec_blocks2.{i}", (f"dec_blocks2_{i}",))
    ln("dec_norm", ("dec_norm",))
    for n in (1, 2):
        t = f"downstream_head{n}"
        if head_type == "linear":
            linear(f"{t}.proj", (t, "proj"))
        else:
            dpt_head(t, (t,))
    return {k: torch.from_numpy(np.array(v, dtype=np.int8 if v.dtype == np.int8 else np.float32,
                                         order="C"))
            for k, v in sd.items()}

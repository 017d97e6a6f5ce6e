"""setup_s: seconds from the start of the process to the window: imports,
the weights drawn on the card, the program built and loaded, the scenes
made, every shape warmed up (and, in a checkout's first run, the kernels
built)."""


def read(rec):
    return rec["setup_s"]

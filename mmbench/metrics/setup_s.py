"""setup_s (s): process start to the start of the window: the scene, the
kernels loaded (built on a checkout's first run), the warm-up unit."""


def read(rec):
    return rec.setup_s

"""Plain PyTorch forms of the STREAM ops (the paper's Appendix A2).

Twin of `repro/kernels/stream/ref.py`: the function each op computes, in
float32, written the obvious way. The kernel is held against these.
"""


def copy_ref(a, b, s):
    return a.clone()


def scale_ref(a, b, s):
    return s * a


def add_ref(a, b, s):
    return a + b


def triad_ref(a, b, s):
    return a + s * b


REFS = {"copy": copy_ref, "scale": scale_ref, "add": add_ref,
        "triad": triad_ref}

"""The port's STREAM bandwidth probe against the reference's: each op on
the same numpy inputs through `stream_op` (its plain form on CPU tensors)
and the reference's Pallas kernel in interpret mode, for n a multiple of
4 and not; the plain forms; the op table; the wrapper's checks; and the
kernel's build and binding. The CUDA kernel runs only on the card;
`chip_smoke.py` holds it against the plain forms there and times it."""

import ctypes
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# Plans follow the planner's rules, never a winner persisted in the
# host's default autotune cache (the reference's conftest turns its
# own off); tests of the cache point it at files of their own.
os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.stream import ops as jops  # noqa: E402
from repro.kernels.stream import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stream import ops, ref  # noqa: E402

SIZES = [1024, 1027, 1, 4099]       # multiples of 4 and ragged tails
# the reference's XLA on the CPU fuses a + s * b into one rounding; the
# port's plain form rounds s * b, then the sum, as its kernel does. The
# two differ by at most an ulp of the result and half an ulp of s b: an
# ulp-level bound per element (a relative one means nothing where a + s b
# cancels)
ULP = 2.0 ** -23


def _operands(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return a, b


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["copy", "scale", "add", "triad"])
def test_stream_op_matches_reference(op, n):
    a, b = _operands(n, seed=n)
    got = ops.stream_op(torch.from_numpy(a), torch.from_numpy(b), 3.0, op=op)
    want = jops.stream_op(jnp.asarray(a), jnp.asarray(b), 3.0, op=op,
                          block=256)
    assert got.dtype == torch.float32 and got.shape == (n,)
    oracle = np.asarray(jref.REFS[op](jnp.asarray(a), jnp.asarray(b), 3.0))
    if op == "triad":
        bound = ULP * (np.abs(oracle) + 3.0 * np.abs(b))
        assert (np.abs(got.numpy() - np.asarray(want)) <= bound).all()
        assert (np.abs(got.numpy() - oracle) <= bound).all()
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("op", ["copy", "scale", "add", "triad"])
def test_plain_forms_are_the_wrapper_on_cpu(op):
    a, b = (torch.from_numpy(v) for v in _operands(1027, seed=1))
    got = ops.stream_op(a, b, 2.5, op=op)
    assert torch.equal(got, ref.REFS[op](a, b, 2.5))
    want = {"copy": a, "scale": 2.5 * a, "add": a + b,
            "triad": a + 2.5 * b}[op]
    assert torch.equal(got, want)
    if op == "copy":                 # a new tensor, as the kernel writes
        assert got.data_ptr() != a.data_ptr()


def test_op_table_matches_reference():
    assert ops.OPS == jops.OPS
    assert ops.BYTES_PER_ELEM == jops.BYTES_PER_ELEM
    assert sorted(ref.REFS) == sorted(jref.REFS) == sorted(ops.OPS)


def test_block_is_accepted_and_ignored():
    a, b = (torch.from_numpy(v) for v in _operands(100))
    assert torch.equal(ops.stream_op(a, b, op="triad", block=7),
                       ops.stream_op(a, b, op="triad"))


@pytest.mark.parametrize("case,exc", [
    ("unknown_op", ValueError), ("two_dim", ValueError),
    ("empty", ValueError), ("f64", TypeError), ("shapes_differ", ValueError),
    ("not_contiguous", ValueError)])
def test_wrapper_rejects(case, exc):
    a, b = (torch.from_numpy(v) for v in _operands(64))
    kw = {"op": "triad"}
    if case == "unknown_op":
        kw["op"] = "fma"
    elif case == "two_dim":
        a, b = a.reshape(8, 8), b.reshape(8, 8)
    elif case == "empty":
        a, b = a[:0], b[:0]
    elif case == "f64":
        a = a.double()
    elif case == "shapes_differ":
        b = b[:32]
    elif case == "not_contiguous":
        a, b = a[::2], b[::2]
    with pytest.raises(exc):
        ops.stream_op(a, b, **kw)


def test_cpu_calls_launch_nothing():
    before = dict(ops.LAUNCHES)
    a, b = (torch.from_numpy(v) for v in _operands(64))
    for op in ops.OPS:
        ops.stream_op(a, b, op=op)
    assert ops.LAUNCHES == before and ops._lib is None


def test_build_command_names_sm90a_and_the_source():
    cmd = _build.nvcc_command("nvcc", ops.SOURCE,
                              _build.library_path(ops.SOURCE))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith(os.path.join("stream", "csrc", "stream.cu"))
    assert _build.library_path(ops.SOURCE).name.startswith("stream-")


def test_ctypes_signature_matches_source():
    src = ops.SOURCE.read_text()
    for name, (argtypes, restype) in ops.SIGNATURES.items():
        m = re.search(rf"\b(int|void) {name}\(([^)]*)\)\s*\{{", src)
        params = [p.strip() for p in m.group(2).split(",")]
        assert len(params) == len(argtypes), name
        assert (restype is None) == (m.group(1) == "void"), name
        for p, t in zip(params, argtypes):
            if "*" in p:
                assert t is ctypes.c_void_p, p
            elif p.startswith("long long"):
                assert t is ctypes.c_longlong, p
            elif p.startswith("float"):
                assert t is ctypes.c_float, p
            else:
                assert p.startswith("int ") and t is ctypes.c_int, p


def test_source_names_what_it_replaces():
    src = ops.SOURCE.read_text()
    assert "src/repro/kernels/stream/kernel.py:35" in src
    for i, op in enumerate(ops.OPS):
        assert f"case {i}: return launch<{i}>" in src
        assert f"{i} {op}" in src.split("int stream_launch")[0]
    assert "float4" in src and "atomicAdd" not in src
    # the chosen design: a grid that covers the arrays once, one float4
    # of each array a thread in blocks of 1,024, read-only loads
    assert "constexpr int kThreads = 1024;" in src
    assert "__ldg(reinterpret_cast<const float4*>(a) + t)" in src
    assert "gridDim" not in src.split("extern \"C\"")[0]
    assert "__fmul_rn" in src and "__fadd_rn" in src

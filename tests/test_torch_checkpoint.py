"""The port's checkpointing (repro_torch.checkpoint): the reference's six
cases (`tests/test_checkpoint.py`) on torch trees, then the shared on-disk
format: a checkpoint written by either package opens in the other, f32,
int32, uint8 and bf16 leaves bit for bit, with the reference's key
strings (sorted dict keys, list indices)."""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_pytree as jload  # noqa: E402
from repro.checkpoint import save_pytree as jsave  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    load_pytree, save_pytree)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(8, 4))
                                         .astype(np.float32)),
                   "b": torch.from_numpy(rng.normal(size=(4,))
                                         .astype(np.float32)).to(
                                             torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(tree):
    from repro_torch.checkpoint.manager import _flatten_with_paths
    return [leaf for _, leaf in _flatten_with_paths(tree)]


def test_roundtrip(tmp_path):
    tree = _tree()
    save_pytree(tree, tmp_path, step=7, extras={"note": "x"})
    restored, manifest = load_pytree(_tree(seed=1), tmp_path)
    assert manifest["step"] == 7
    assert manifest["extras"]["note"] == "x"
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_latest_step_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (10, 20, 30):
        mgr.save(_tree(s), step=s, blocking=True)
    assert mgr.latest_step() == 30
    kept = sorted(p.name for p in pathlib.Path(tmp_path).glob("step_*"))
    assert kept == ["step_00000020", "step_00000030"]


def test_async_save_overlaps_and_waits(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(_tree(1), step=1)      # non-blocking
    mgr.save(_tree(2), step=2)      # waits for the first internally
    mgr.wait()
    assert mgr.latest_step() == 2


def test_no_partial_checkpoint_visible(tmp_path):
    """Temp dirs never count as checkpoints (atomic rename contract)."""
    d = pathlib.Path(tmp_path)
    (d / ".tmp_step_00000099_123").mkdir(parents=True)
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() is None


def test_restore_missing_leaf_raises(tmp_path):
    save_pytree({"a": torch.zeros((2,))}, tmp_path, step=1)
    with pytest.raises(KeyError):
        load_pytree({"a": torch.zeros((2,)), "c": torch.zeros((2,))},
                    tmp_path, step=1)


def test_manifest_records_shapes(tmp_path):
    save_pytree(_tree(), tmp_path, step=3)
    manifest = json.loads(
        (pathlib.Path(tmp_path) / "step_00000003" / "manifest.json")
        .read_text())
    assert manifest["leaves"]["params/w"]["shape"] == [8, 4]


def test_save_copies_before_the_caller_mutates(tmp_path):
    """The manager takes its host copy before save() returns, so the
    caller may change the state while the background write runs (the
    server's partial s_W buffer is written in place)."""
    out = np.arange(6, dtype=np.float32)
    mgr = CheckpointManager(tmp_path)
    mgr.save({"s_w": out}, step=1)
    out[:] = -1.0
    mgr.wait()
    got, _ = load_pytree({"s_w": out}, tmp_path)
    np.testing.assert_array_equal(got["s_w"].numpy(), np.arange(6))


def _mixed(seed):
    rng = np.random.default_rng(seed)
    return {
        "z": rng.normal(size=(3, 5)).astype(np.float32),
        "a": [rng.integers(-9, 9, size=(4,)).astype(np.int32),
              rng.integers(0, 255, size=(6,)).astype(np.uint8)],
        "m": {"bf": rng.normal(size=(2, 7)).astype(np.float32)},
    }


def _torch_tree(t):
    return {"z": torch.from_numpy(t["z"]),
            "a": [torch.from_numpy(t["a"][0]), torch.from_numpy(t["a"][1])],
            "m": {"bf": torch.from_numpy(t["m"]["bf"]).to(torch.bfloat16)}}


def _jax_tree(t):
    return {"z": jnp.asarray(t["z"]),
            "a": [jnp.asarray(t["a"][0]), jnp.asarray(t["a"][1])],
            "m": {"bf": jnp.asarray(t["m"]["bf"]).astype(jnp.bfloat16)}}


def _bits(x) -> np.ndarray:
    """The raw bytes of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.contiguous().numpy().view(np.uint8)
    x = np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint8)


def test_port_checkpoint_opens_in_the_reference(tmp_path):
    t = _mixed(0)
    save_pytree(_torch_tree(t), tmp_path, step=5, extras={"k": 1})
    got, manifest = jload(_jax_tree(_mixed(1)), tmp_path)
    assert manifest["extras"] == {"k": 1}
    assert sorted(manifest["leaves"]) == ["a/0", "a/1", "m/bf", "z"]
    assert manifest["leaves"]["m/bf"]["dtype"] == "bfloat16"
    want = _torch_tree(t)
    for k in ("z",):
        assert got[k].dtype == jnp.float32
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    assert got["a"][0].dtype == jnp.int32 and got["a"][1].dtype == jnp.uint8
    for i in (0, 1):
        np.testing.assert_array_equal(_bits(got["a"][i]),
                                      _bits(want["a"][i]))
    assert got["m"]["bf"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(got["m"]["bf"]),
                                  _bits(want["m"]["bf"]))


def test_reference_checkpoint_opens_in_the_port(tmp_path):
    t = _mixed(2)
    jsave(_jax_tree(t), tmp_path, step=9, extras={"k": 2})
    got, manifest = load_pytree(_torch_tree(_mixed(3)), tmp_path)
    assert manifest["step"] == 9 and manifest["extras"] == {"k": 2}
    want = _jax_tree(t)
    assert got["z"].dtype == torch.float32
    assert got["a"][0].dtype == torch.int32
    assert got["a"][1].dtype == torch.uint8
    assert got["m"]["bf"].dtype == torch.bfloat16
    for g, w in ((got["z"], want["z"]), (got["a"][0], want["a"][0]),
                 (got["a"][1], want["a"][1]), (got["m"]["bf"],
                                               want["m"]["bf"])):
        np.testing.assert_array_equal(_bits(g), _bits(w))

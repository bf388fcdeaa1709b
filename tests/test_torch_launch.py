"""The port's PERMANOVA CLI under the reference's legacy --kernel flag:
for each --impl value the header names the impl the reference's CLI
names, the plan runs the registry impl that name aliases, and F and p
match the reference's CLI on the same study (F at rtol 1e-4; a strong
effect puts p at its floor on both label streams)."""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

# Plans follow the planner's rules, never a winner persisted in the
# host's default autotune cache.
os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

from repro.launch import permanova as jcli  # noqa: E402
from repro_torch.engine import registry  # noqa: E402
from repro_torch.launch import permanova as cli  # noqa: E402

ARGV = ["--samples", "64", "--features", "16", "--groups", "4",
        "--perms", "19", "--kernel"]
RTOL = 1e-4


def _fields(out: str) -> dict:
    """impl=, the plan line's impl, F and p of a CLI run's output."""
    lines = out.splitlines()
    head = next(ln for ln in lines if " impl=" in ln)
    plan = next(ln for ln in lines if "plan: " in ln)
    res = next(ln for ln in lines if " F=" in ln)
    return {"impl": head.split(" impl=")[1].split()[0],
            "plan": plan.split("plan: ")[1].split("[")[0],
            "F": float(res.split("F=")[1].split()[0]),
            "p": float(res.split("p=")[1].split()[0])}


@pytest.mark.parametrize("impl", cli.IMPL_CHOICES)
def test_kernel_flag_maps_as_the_reference(impl, capsys, monkeypatch):
    assert cli.main(ARGV + ["--impl", impl, "--device", "cpu"]) == 0
    got = _fields(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["permanova"] + ARGV + ["--impl", impl])
    assert jcli.main() == 0
    want = _fields(capsys.readouterr().out)
    assert got["impl"] == want["impl"] == want["plan"]
    assert got["impl"] == (impl if impl.startswith("pallas_")
                           else cli.KERNEL_IMPLS[impl])
    assert got["plan"] == registry.ALIASES[got["impl"]]
    assert got["F"] == pytest.approx(want["F"], rel=RTOL)
    assert got["p"] == want["p"] == 1 / 20

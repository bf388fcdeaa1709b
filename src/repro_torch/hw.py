"""Target-hardware constants for the port, and device resolution.

The target is one NVIDIA H100 SXM. The numbers are NVIDIA's datasheet
values (dense rates, no sparsity) at the card's full 700 W power limit;
a card set to a lower limit runs slower under load, so every measurement
is reported beside `nvidia-smi`'s name and power limit.

The interconnect is that of an 8-GPU HGX H100 node (NVIDIA's H100 and
DGX H100 datasheets): NVLink 4 joins the node's cards at 900 GB/s per
card in total, 450 GB/s each way, and each card has its own 400 Gb/s NDR
InfiniBand port (50 GB/s) to the other nodes. The dry-run's collective
term (`roofline.analysis`) divides a collective's bytes by the first when
its group's ranks stay within one node of `node_gpus` consecutive ranks,
by the second otherwise: the reference's one ICI link rate becomes two.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s, dense tensor cores
    peak_flops_f32: float       # FLOP/s, CUDA cores (non-tensor) FMA
    hbm_bandwidth: float        # B/s
    hbm_bytes: float            # device memory
    l2_bytes: float
    sms: int
    smem_per_block: int         # bytes a block may opt in to (above
                                # 48 KB: cudaFuncSetAttribute first)
    nvlink_bandwidth: float     # B/s each way, card to card in a node
    ib_bandwidth: float         # B/s a card's own port between nodes
    node_gpus: int              # cards joined by NVLink


H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    hbm_bandwidth=3.35e12,
    hbm_bytes=80e9,
    l2_bytes=50e6,
    sms=132,
    smem_per_block=232_448,     # 227 KB
    nvlink_bandwidth=450e9,     # NVLink 4: 900 GB/s in total
    ib_bandwidth=50e9,          # NDR InfiniBand: 400 Gb/s
    node_gpus=8,                # HGX H100 8-GPU
)

# The paper's benchmark workload (EMP, Fig. 1).
PAPER_N_DIMS = 25145
PAPER_N_PERMS = 3999

# The paper's MI300A CPU STREAM triad (App. A2), B/s: obs.report's
# reference bandwidth on 'cpu', so a CPU report reads as the reference's.
# It was measured on the paper's machine, not for this port.
MI300A_CPU_STREAM_TRIAD = 0.209e12

TARGET = H100_SXM


def ridge_point_bf16(chip: ChipSpec = TARGET) -> float:
    """FLOP/byte where the card turns from memory- to compute-bound on
    the bf16 tensor cores (295 at the H100 SXM's datasheet rates)."""
    return chip.peak_flops_bf16 / chip.hbm_bandwidth


def ridge_point_f32(chip: ChipSpec = TARGET) -> float:
    """The same on the f32 CUDA cores (20 FLOP/byte)."""
    return chip.peak_flops_f32 / chip.hbm_bandwidth


def resolve_device(device="cuda") -> torch.device:
    """The torch.device to run on. Asking for CUDA where there is no CUDA
    device raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch forms on "
            "the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; 'cuda' or 'cpu'")
    return dev

"""Runtime-adaptive grain-size control (paper R4).

Counterpart: ``repro/core/granularity.py`` (``GrainDecision``,
``GrainPolicy``).  The napkin math is the reference's: the gradient
fusion cap balances per-collective latency against the bandwidth cost of
delaying overlap, the microbatch count and the remat policy keep
activations within device memory, and the attention tiles fit on chip.
Every decision comes with the numbers that produced it.

The constants are the card's and the wire's, not the reference's TPU
v5e numbers: an NVIDIA H100 80GB HBM3 (989 TFLOP/s dense bf16, 3.35 TB/s
of HBM, 80 GB), and for the wire gloo's loopback between two rank
processes on one host, staged from and to the card, as
``chip_smoke.py``'s ``wire_probe`` measured it on an H100 machine (the
median of 9 float32 all-reduces of 32 MiB for the rate, of 4 bytes for
the latency).  The port acts on ``bucket_bytes`` alone (the
phylanx strategy's fusion cap, through ``Strategy.resolve_bucket_bytes``);
the microbatch count, the remat policy and the attention tiles are
computed for the record and used nowhere: the kernels pick their own
tiles, and remat and gradient accumulation are the plan's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["GrainDecision", "GrainPolicy"]

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9
WIRE_BW = 1.151e9            # bytes/s: a 32 MiB all-reduce (PERF.md §6)
COLL_LATENCY = 1.039e-3      # s: a 4-byte all-reduce (PERF.md §6)


@dataclasses.dataclass(frozen=True)
class GrainDecision:
    bucket_bytes: int
    n_microbatches: int
    remat: str                     # "none" | "block" | "full"
    attn_block_q: int
    attn_block_kv: int
    rationale: dict[str, Any]


class GrainPolicy:
    """Derive grain sizes from (model stats, mesh, shape) napkin math."""

    @staticmethod
    def bucket_bytes(total_grad_bytes: int, n_tensors: int, dp_degree: int,
                     backward_time_s: float) -> int:
        """The fusion cap: per-bucket wire time matched to about 4x the
        collective latency, clamped to [1 MiB, 64 MiB], and never fewer
        than 2 buckets when there is anything to overlap."""
        if dp_degree <= 1 or total_grad_bytes == 0:
            return max(total_grad_bytes, 1)
        hops = dp_degree - 1
        target = 4.0 * COLL_LATENCY * hops * WIRE_BW / max(
            2 * (dp_degree - 1) / dp_degree, 1e-9)
        cap = int(min(max(target, 1 << 20), 64 << 20))
        if total_grad_bytes > cap and total_grad_bytes // cap < 2:
            cap = total_grad_bytes // 2 + 1
        return cap

    @staticmethod
    def microbatches(global_batch: int, dp_degree: int, seq: int,
                     d_model: int, n_layers: int, hbm_bytes: float = None,
                     per_act_bytes: int = 2) -> int:
        """Split the per-replica batch until checkpointed activations fit
        a quarter of device memory."""
        hbm_bytes = HBM_BYTES if hbm_bytes is None else hbm_bytes
        local_b = max(global_batch // max(dp_degree, 1), 1)
        act = local_b * seq * d_model * per_act_bytes * n_layers
        n = 1
        while act / n > 0.25 * hbm_bytes and n < local_b:
            n *= 2
        return min(n, local_b)

    @staticmethod
    def remat_policy(n_layers: int, d_model: int, seq: int, local_batch: int,
                     hbm_bytes: float = None) -> str:
        hbm_bytes = HBM_BYTES if hbm_bytes is None else hbm_bytes
        full_acts = n_layers * local_batch * seq * d_model * 2 * 12
        return "none" if full_acts < 0.3 * hbm_bytes else "block"

    @staticmethod
    def attn_blocks(seq: int, head_dim: int) -> tuple[int, int]:
        """Attention tiles: 128-aligned, the working set ``(bq*d +
        2*bkv*d + bq*bkv) * 4`` bytes under 8 MiB."""
        bq = 128 if seq >= 128 else max(8, seq)
        bkv = 128
        while (bq * head_dim + 2 * bkv * head_dim + bq * bkv) * 4 < 8 << 20 \
                and bkv < min(seq, 2048):
            bkv *= 2
        bkv = min(bkv, max(seq, 128))
        return bq, bkv

    @classmethod
    def derive(cls, *, n_params: int, n_tensors: int, global_batch: int,
               seq: int, d_model: int, n_layers: int, head_dim: int,
               dp_degree: int, grad_bytes_per_param: int = 2
               ) -> GrainDecision:
        grad_bytes = n_params * grad_bytes_per_param
        # rough backward time: 4N*D flops (bwd ~2x fwd) at 40% MFU
        tokens = global_batch * seq
        bwd_t = 4 * n_params * tokens / max(dp_degree, 1) / (0.4 * PEAK_FLOPS)
        cap = cls.bucket_bytes(grad_bytes, n_tensors, dp_degree, bwd_t)
        micro = cls.microbatches(global_batch, dp_degree, seq, d_model,
                                 n_layers)
        remat = cls.remat_policy(n_layers, d_model, seq,
                                 max(global_batch // max(dp_degree, 1), 1))
        bq, bkv = cls.attn_blocks(seq, head_dim)
        return GrainDecision(
            bucket_bytes=cap, n_microbatches=micro, remat=remat,
            attn_block_q=bq, attn_block_kv=bkv,
            rationale={
                "grad_bytes": grad_bytes, "est_backward_s": bwd_t,
                "dp_degree": dp_degree, "n_tensors": n_tensors,
                "tokens": tokens,
            })

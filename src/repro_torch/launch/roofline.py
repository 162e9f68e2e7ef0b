"""Roofline of one step on one NVIDIA H100, from a reckoned step.

The single-card counterpart of ``repro/launch/roofline.py``. The terms,
in seconds, as there:

    compute    = Σ_dtype FLOPs_dtype / (chips × peak_dtype)
    memory     = bytes / (chips × HBM_bw)
    collective = collective_bytes / (chips × link_bw)

where the FLOPs and bytes are those of the operators the eager step
dispatches (``launch/step_cost.py``; the JAX package reads them from the
optimized HLO, and keeps the names ``hlo_flops`` and ``hlo_bytes``, which
the records here keep too). Each product's FLOPs count against the peak of
the dtype it runs in: bfloat16 products against the tensor cores' 989
TFLOP/s, float32 ones (the port turns TF32 off, ``repro_torch/__init__.py``)
against 67. The flash kernel's count at its inputs' dtype: it multiplies
in float32 on the CUDA cores, but a bfloat16 call's least time is the
tensor cores', so the gap is the kernel's. On one card ``chips = 1``
and nothing crosses a link: the collective term is 0.

Hardware model: one H100 SXM at its 700 W limit, the published dense
peaks of NVIDIA's data sheet: 989 TFLOP/s bf16, 495 TF32, 67 float32
outside the tensor cores; 3.35 TB/s and 80 GB of HBM.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_FLOPS = 989e12  # bf16 dense, the peak MFU and the roofline fraction use
PEAKS = {"bf16": PEAK_FLOPS, "tf32": 495e12, "fp32": 67e12}
HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 80e9  # the card's memory, as the fit of a cell counts it
CARD = "1xH100"


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh_desc: str
    chips: int
    hlo_flops: float  # the counted step's FLOPs (products)
    hlo_bytes: float  # its operators' bytes, each input read and output written once
    collective_bytes: float
    collective_detail: dict
    model_flops: float  # 6·N·D (dense) / 6·N_active·D (MoE)
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    min_bytes: float = 0.0  # the least bytes the step must move (launch/specs.py)
    measured_s: Optional[float] = None  # a step's time on the card, where measured
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0

    def __post_init__(self):
        self.t_compute = sum(f / (self.chips * PEAKS[c])
                             for c, f in self.flops_by_dtype.items())
        self.t_memory = self.hlo_bytes / (self.chips * HBM_BW)
        self.t_collective = 0.0  # one card: nothing crosses a link

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def bound_time(self) -> float:
        """Lower bound on step time = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def compute_roofline_fraction(self) -> float:
        """Fraction of peak the step would reach if it ran at the bound:
        useful FLOPs / (chips · peak · bound_time)."""
        denom = self.chips * PEAK_FLOPS * self.bound_time
        return self.model_flops / denom if denom else 0.0

    @property
    def mfu(self) -> Optional[float]:
        """Model FLOPs over the bf16 peak times the measured step time;
        None where no time was measured."""
        if not self.measured_s:
            return None
        return self.model_flops / (self.chips * PEAK_FLOPS * self.measured_s)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh_desc,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "min_bytes": self.min_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_detail": dict(self.collective_detail),
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_min_memory_s": self.min_bytes / (self.chips * HBM_BW),
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "bound_time_s": self.bound_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.compute_roofline_fraction,
            "measured_s": self.measured_s,
            "mfu": self.mfu,
        }


def model_flops_for_cell(cfg, shape_cfg) -> float:
    """6·N·D with N = active params (MoE counts routed-in experts only).
    Train: 6·N·D (fwd+bwd). Prefill: 2·N·D. Decode: 2·N·B (one token)."""
    n_active = cfg.active_param_count()
    if shape_cfg.kind == "train":
        return 6.0 * n_active * shape_cfg.seq_len * shape_cfg.global_batch
    if shape_cfg.kind == "prefill":
        return 2.0 * n_active * shape_cfg.seq_len * shape_cfg.global_batch
    return 2.0 * n_active * shape_cfg.global_batch  # decode: 1 new token


def analyze(cost, arch: str, shape: str, cfg, shape_cfg, min_bytes: float,
            measured_s: Optional[float] = None) -> Roofline:
    """The roofline of a step reckoned by ``cost`` (a
    ``launch/step_cost.py:StepCost``) on one card."""
    return Roofline(arch=arch, shape=shape, mesh_desc=CARD, chips=1,
                    hlo_flops=cost.total_flops(), hlo_bytes=cost.bytes,
                    collective_bytes=0.0, collective_detail={},
                    model_flops=model_flops_for_cell(cfg, shape_cfg),
                    flops_by_dtype=dict(cost.flops), min_bytes=min_bytes,
                    measured_s=measured_s)

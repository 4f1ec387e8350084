"""BandwidthProfile — the interconnect constants of the cost model
(``repro.tuning.profile``, whole).

Every α–β term the port uses to predict communication time lives here:
the cost model (``repro_torch.tuning.cost``), ``DistributedOptimizer.
exchange_stats`` and the trace metadata read the same presets as the
reference, so the two packages predict the same microseconds for the
same plan.  The presets are the reference's, carried over as data for
parity of predictions: none of their figures is a measurement of the
H100 this port runs on (a profile of the card needs link bandwidths one
card cannot measure).

A profile is deliberately coarse — two bandwidth classes and two
latency classes:

  * the **innermost** mesh level (within a node / pod) runs on
    ``local_bw`` / ``local_alpha``;
  * every **outer** level — and any FLAT collective, which must cross
    the slowest links of the whole mesh — runs on ``cross_bw`` /
    ``cross_alpha``.

That asymmetry is exactly what makes hierarchical Σ(p_k−1) exchanges
beat flat (P−1) gathers on ethernet-class interconnects and tie on
uniform TPU ICI (see docs/tuning.md).

Profiles are pure data: importing this module touches no tensor.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple, Union


@dataclasses.dataclass(frozen=True)
class BandwidthProfile:
    """α–β interconnect model + local roofline constants.

    ``cross_*`` describes the outermost (slowest) links, ``local_*``
    the innermost mesh level.  ``hbm_bw`` and ``peak_flops`` are the
    per-device memory/compute roofline terms (used both to bill codec
    encode/decode passes and by ``dryrun.analyse``).
    """
    name: str
    cross_bw: float = 12.5e9   # B/s on the outermost links
    local_bw: float = 25e9     # B/s on the innermost mesh level
    cross_alpha: float = 5e-6  # s launch latency per collective op, outer
    local_alpha: float = 2e-6  # s launch latency per collective op, inner
    hbm_bw: float = 819e9      # B/s local memory bandwidth
    peak_flops: float = 197e12  # FLOP/s per device

    def level_bandwidth(self, level: int, n_levels: int) -> float:
        """β for mesh level ``level`` (0 = outermost).  Only the
        innermost level of a multi-level mesh stays on fast local
        links; flat (1-level) collectives span the slow ones."""
        if n_levels > 1 and level == n_levels - 1:
            return self.local_bw
        return self.cross_bw

    def level_alpha(self, level: int, n_levels: int) -> float:
        """α for mesh level ``level`` (0 = outermost)."""
        if n_levels > 1 and level == n_levels - 1:
            return self.local_alpha
        return self.cross_alpha

    def to_dict(self) -> Dict[str, Union[str, float]]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Union[str, float]]
                  ) -> "BandwidthProfile":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown BandwidthProfile fields "
                             f"{sorted(unknown)} (expected a subset of "
                             f"{sorted(fields)})")
        return cls(**d)

    @classmethod
    def from_json(cls, path: str) -> "BandwidthProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# Named presets, the reference's values (repro/tuning/profile.py), which
# it anchors on constants of its own benchmarks and launchers:
#   * ib.cross_bw = 12.5e9      — Omni-Path 100 Gb/s, the paper's
#                                 cluster (benchmarks/scaling_model.BW)
#   * tpu.{cross_bw,hbm_bw,peak_flops} — TPU v5e per chip
#                                 (repro.launch.mesh ICI_BW / HBM_BW /
#                                 PEAK_FLOPS_BF16)
#   * ethernet                  — 10GbE cross-node, in-node NVLink-less
#                                 host fabric: the bandwidth-starved
#                                 deployment the codecs target
#   * cpu                       — shared-memory emulated workers
#                                 (XLA_FLAGS device_count): wire is a
#                                 memcpy, so codec compute passes and
#                                 launch latency dominate.  This is the
#                                 profile measured trials on emulated
#                                 meshes should be ranked against.
PROFILES: Dict[str, BandwidthProfile] = {
    p.name: p for p in (
        BandwidthProfile(name="ethernet", cross_bw=1.25e9,
                         local_bw=12.5e9, cross_alpha=25e-6,
                         local_alpha=5e-6, hbm_bw=100e9,
                         peak_flops=5e12),
        BandwidthProfile(name="ib", cross_bw=12.5e9, local_bw=25e9,
                         cross_alpha=5e-6, local_alpha=2e-6,
                         hbm_bw=200e9, peak_flops=20e12),
        BandwidthProfile(name="tpu", cross_bw=50e9, local_bw=50e9,
                         cross_alpha=1e-6, local_alpha=1e-6,
                         hbm_bw=819e9, peak_flops=197e12),
        BandwidthProfile(name="cpu", cross_bw=4e9, local_bw=4e9,
                         cross_alpha=20e-6, local_alpha=20e-6,
                         hbm_bw=8e9, peak_flops=0.5e12),
    )
}


def available_profiles() -> Tuple[str, ...]:
    return tuple(sorted(PROFILES))


def get_profile(spec: Union[str, BandwidthProfile]) -> BandwidthProfile:
    """Resolve a profile: an instance, a preset name, or a path to a
    JSON override file (any ``BandwidthProfile`` field subset plus
    ``name``)."""
    if isinstance(spec, BandwidthProfile):
        return spec
    if spec in PROFILES:
        return PROFILES[spec]
    if isinstance(spec, str) and (spec.endswith(".json")
                                  or os.path.exists(spec)):
        return BandwidthProfile.from_json(spec)
    raise ValueError(f"unknown bandwidth profile {spec!r} (presets: "
                     f"{', '.join(available_profiles())}; or a path to "
                     f"a JSON override)")

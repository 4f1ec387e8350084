"""Analytic α–β cost model over compiled ExchangePlans
(``repro.tuning.cost``, whole).

Computed from the same per-stage / per-hop accounting the wire recorder
is held to at run time (``plan.stage_hop_wire_bytes`` /
``plan.stage_hop_ops``, the comm layer's call counts), so a plan whose
measured wire is exact is costed from checked numbers.  The port's plan
accounting equals the reference's for the same tree, so the predictions
are the reference's to the last bit.

Per stage, per mesh-level hop ``k`` (0 = outermost):

    t_hop = α_k · ops_k  +  bytes_k / β_k

with α_k / β_k from the ``BandwidthProfile`` (outer levels on the slow
cross links, the innermost level of a multi-axis mesh on fast local
links — flat collectives span the slow links).  Non-linear codecs add
one full-precision encode/decode round per requantize hop, billed as
``cost_passes`` memory sweeps of the bucket against ``hbm_bw``; codec
state (error-feedback residuals) adds one read+write sweep per step.

The model ranks, it does not simulate: overlap modes move the same
bytes, so candidates differing only in overlap tie here.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

from repro_torch.tuning.profile import BandwidthProfile, get_profile

Levels = Union[int, Sequence[int]]


def predict_stage_us(plan, stage, n_workers: Levels,
                     profile: Union[str, BandwidthProfile]) -> float:
    """Predicted communication time of one BucketStage, µs/step."""
    prof = get_profile(profile)
    hop_bytes = plan.stage_hop_wire_bytes(stage, n_workers)
    hop_ops = plan.stage_hop_ops(stage, n_workers)
    n = max(len(hop_bytes), len(hop_ops))
    t = 0.0
    for k in range(n):
        b = hop_bytes[k] if k < len(hop_bytes) else 0
        ops = hop_ops[k] if k < len(hop_ops) else 0
        t += prof.level_alpha(k, n) * ops + b / prof.level_bandwidth(k, n)
    # codec compute: full-precision sweeps of the bucket per
    # encode/decode round — one round per requantize hop for non-linear
    # codecs (len(hop_ops) hops on hierarchical meshes), one otherwise
    codec = plan.config.codec_obj
    if codec.cost_passes:
        rounds = len(hop_ops) if not codec.linear else 1
        buf_bytes = 4 * plan.stage_n_elems(stage)
        t += codec.cost_passes * rounds * buf_bytes / prof.hbm_bw
    return t * 1e6


def stage_costs_us(plan, n_workers: Levels,
                   profile: Union[str, BandwidthProfile]
                   ) -> Tuple[float, ...]:
    """Per-stage predicted communication time, schedule order."""
    return tuple(predict_stage_us(plan, s, n_workers, profile)
                 for s in plan.schedule.stages)


def predict_comm_us(plan, n_workers: Levels,
                    profile: Union[str, BandwidthProfile]) -> float:
    """Predicted total communication time of one exchange, µs/step.

    The sum of the schedule's per-stage predictions plus one
    read+write sweep of the codec-state residuals (stateful codecs
    touch their full f32 state every step)."""
    prof = get_profile(profile)
    total = sum(stage_costs_us(plan, n_workers, prof))
    state = plan.state_bytes()
    if state:
        total += 2 * state / prof.hbm_bw * 1e6
    return total


def roofline_terms(flops_per_device: float, hbm_bytes: float,
                   collective_bytes: float,
                   profile: Union[str, BandwidthProfile]
                   ) -> Dict[str, float]:
    """The dry-run roofline: per-device step-time lower bounds from the
    three resources, plus which one dominates."""
    prof = get_profile(profile)
    terms = {
        "compute_s": flops_per_device / prof.peak_flops,
        "memory_s": hbm_bytes / prof.hbm_bw,
        "collective_s": collective_bytes / prof.cross_bw,
    }
    terms["dominant"] = max(terms, key=terms.get)
    return terms


def alpha_beta_time_s(total_bytes: float, n_collectives: int,
                      n_workers: int,
                      profile: Union[str, BandwidthProfile]) -> float:
    """Classic flat α–β estimate (benchmarks' closed-form companion):
    ``α · n_coll · log2(P) + bytes / β_cross``."""
    prof = get_profile(profile)
    lat = (prof.cross_alpha * n_collectives * math.log2(n_workers)
           if n_workers > 1 else 0.0)
    return lat + total_bytes / prof.cross_bw

"""The exchange cost model (the part of ``repro.tuning`` ported so far).

``profile`` holds the interconnect constants (``BandwidthProfile`` and
the reference's presets), ``cost`` the α–β model over compiled
ExchangePlans that ``DistributedOptimizer.exchange_stats`` and the trace
metadata read.
"""
from repro_torch.tuning.profile import (BandwidthProfile, available_profiles,
                                        get_profile, PROFILES)
from repro_torch.tuning.cost import (alpha_beta_time_s, predict_comm_us,
                                     predict_stage_us, roofline_terms,
                                     stage_costs_us)

__all__ = ["BandwidthProfile", "PROFILES", "alpha_beta_time_s",
           "available_profiles", "get_profile", "predict_comm_us",
           "predict_stage_us", "roofline_terms", "stage_costs_us"]

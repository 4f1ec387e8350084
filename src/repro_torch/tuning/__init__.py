"""repro_torch.tuning — the exchange autotuner (``repro.tuning``).

Searches the ExchangeConfig space (``space``), scores candidates with
the α–β cost model over the plan's per-stage and per-hop accounting
(``cost``), optionally refines the head with short measured trials in
the live ``torch.distributed`` world, and caches the winner as a
versioned JSON artifact keyed by (structural tree fingerprint, workers,
bandwidth profile) (``search``).  Interconnect constants live in
``profile``.

    python -m repro_torch.launch.tune [--trials N] [--profile ...]  # search
    python -m repro_torch.launch.train --tuned                     # consume
"""
from repro_torch.tuning.profile import (BandwidthProfile, available_profiles,
                                        get_profile, PROFILES)
from repro_torch.tuning.cost import (alpha_beta_time_s, predict_comm_us,
                                     predict_stage_us, roofline_terms,
                                     stage_costs_us)
from repro_torch.tuning.space import (Candidate, describe_config,
                                      enumerate_space, mesh_levels)
from repro_torch.tuning.search import (ARTIFACT_VERSION, TuningArtifactError,
                                       TuningResult, artifact_key,
                                       artifact_path, config_from_dict,
                                       config_to_dict, load_artifact,
                                       load_tuned_config, measure_candidates,
                                       rank_candidates, save_artifact, search)

__all__ = ["ARTIFACT_VERSION", "BandwidthProfile", "Candidate", "PROFILES",
           "TuningArtifactError", "TuningResult", "alpha_beta_time_s",
           "artifact_key", "artifact_path", "available_profiles",
           "config_from_dict", "config_to_dict", "describe_config",
           "enumerate_space", "get_profile", "load_artifact",
           "load_tuned_config", "measure_candidates", "mesh_levels",
           "predict_comm_us", "predict_stage_us", "rank_candidates",
           "roofline_terms", "save_artifact", "search", "stage_costs_us"]

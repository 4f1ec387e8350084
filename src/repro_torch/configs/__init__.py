from repro_torch.configs.base import (ARCH_IDS, ArchConfig, FrontendConfig,
                                      MoEConfig, SSMConfig, get_config)

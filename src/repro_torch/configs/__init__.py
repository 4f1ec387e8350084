from repro_torch.configs.base import (ARCH_IDS, ArchConfig, FrontendConfig,
                                      SSMConfig, get_config)

from repro_torch.configs.base import (ARCH_IDS, ArchConfig, FrontendConfig,
                                      MLAConfig, MoEConfig, SSMConfig,
                                      XLSTMConfig, get_config)

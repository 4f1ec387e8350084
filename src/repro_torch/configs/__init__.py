from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, ArchConfig,
                                      FrontendConfig, InputShape, MLAConfig,
                                      MoEConfig, SSMConfig, XLSTMConfig,
                                      all_configs, get_config)

from repro_torch.configs.base import (ARCH_IDS, EliteKVConfig, ModelConfig,
                                      get_config, make_inputs)

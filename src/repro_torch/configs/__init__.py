from repro_torch.configs.base import (ARCH_IDS, SHAPES, EliteKVConfig, ModelConfig,
                                      ShapeConfig, cell_applicable, get_config,
                                      input_specs, make_inputs)

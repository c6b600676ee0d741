"""Architecture registry: ``--arch <id>`` resolves here.  The port's own
copy of the reference's configs (``repro/configs``), equal field for
field."""
from repro_torch.configs import (deepseek_7b, deepseek_v2_236b,
                                 deepseek_v2_lite_16b, mamba2_780m,
                                 mistral_large_123b, phi3_mini_3_8b,
                                 qwen2_5_3b, qwen2_vl_72b, recurrentgemma_9b,
                                 seamless_m4t_medium)
from repro_torch.configs.base import (SHAPES, SUBQUADRATIC, ModelConfig,
                                      ShapeConfig)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (phi3_mini_3_8b, mistral_large_123b, qwen2_5_3b, deepseek_7b,
              recurrentgemma_9b, deepseek_v2_236b, deepseek_v2_lite_16b,
              seamless_m4t_medium, mamba2_780m, qwen2_vl_72b)
}

__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC", "ModelConfig", "ShapeConfig"]

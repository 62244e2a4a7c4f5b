from . import (deepseek_v2_lite_16b, gemma2_27b,  # noqa: F401
               gemma3_4b, musicgen_medium, phi3_medium_14b, pixtral_12b,
               qwen2_5_3b, qwen3_moe_235b_a22b, xlstm_1_3b, zamba2_7b)

from . import (gemma2_27b, gemma3_4b, phi3_medium_14b,  # noqa: F401
               qwen2_5_3b, qwen3_moe_235b_a22b)

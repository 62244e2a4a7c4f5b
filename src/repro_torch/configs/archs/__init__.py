from . import gemma2_27b, gemma3_4b, phi3_medium_14b, qwen2_5_3b  # noqa: F401

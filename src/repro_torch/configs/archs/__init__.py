from . import qwen2_5_3b  # noqa: F401

from .cuda import flash_attention_cuda
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_attention_cuda"]

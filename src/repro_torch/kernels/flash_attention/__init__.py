from .ops import causal_attention
from .kernel import flash_attention, flash_attention_plain
from .ref import flash_attention_bf16_limit, flash_attention_ref

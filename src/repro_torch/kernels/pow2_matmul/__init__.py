from .ops import pow2_linear, pack_weights
from .kernel import pow2_matmul, pow2_matmul_plain
from .ref import pow2_matmul_ref

"""ray_tpu_torch.ops — the serving and training paths' hot ops, with
hand-written Hopper kernels (csrc/*.cu) beside their plain PyTorch versions.

Dispatch rule (dispatch.py): tensors on the card launch the kernel or
raise; tensors on the CPU take the plain version.
"""

from .attention import (  # noqa: F401
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_with_lse,
    mha_reference,
)
from .norm import layer_norm, rms_norm, rms_norm_reference  # noqa: F401
from .paged_attention import (  # noqa: F401
    paged_attention_chunk,
    paged_attention_decode,
    paged_attention_verify,
)
from .rope import apply_rope, rope_frequencies  # noqa: F401

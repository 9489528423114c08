// The alibi forms of the paged decode kernel (K3-alibi over bf16 and int8
// pools, replacing `_paged_kernel`'s `has_alibi` path of
// `deepspeed_tpu/ops/pallas/paged_attention.py` :89-90, :126-127, :235-242):
// `paged_decode_attention.cu` (which states the function, the bound and the
// design) built with DS_PAGED_ALIBI = 1, a library of its own so that its
// instantiations compile in parallel with the others.
#define DS_PAGED_ALIBI 1
#include "paged_decode_attention.cu"

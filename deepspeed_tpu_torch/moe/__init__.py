from deepspeed_tpu_torch.moe.layer import MoE, Experts, TopKGate
from deepspeed_tpu_torch.moe.sharded_moe import top1gating, top2gating, topkgating

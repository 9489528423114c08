from deepspeed_tpu_torch.models.bloom import (
    BloomConfig, BloomForCausalLM, bloom_config, bloom_loss_fn, init_bloom)
from deepspeed_tpu_torch.models.gptneox import (
    GPTNeoXConfig, GPTNeoXForCausalLM, gptneox_config, gptneox_loss_fn,
    init_gptneox)
from deepspeed_tpu_torch.models.phi import (
    PhiConfig, PhiForCausalLM, init_phi, phi_config, phi_loss_fn)

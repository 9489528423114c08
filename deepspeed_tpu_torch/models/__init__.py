from deepspeed_tpu_torch.models.bloom import (
    BloomConfig, BloomForCausalLM, bloom_config, bloom_loss_fn, init_bloom)

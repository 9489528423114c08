"""Config key names (counterpart of ``deepspeed_tpu/runtime/constants.py``).

Only the keys the port's `DeepSpeedConfig` reads; a DeepSpeed JSON config
keeps its key names.
"""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"
# optimizer types `ops/optimizers.build_optimizer` takes (lower case); the
# 1-bit ones run the engine's wire with `comm_backend_name` in their params
ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM_OPTIMIZER = "fusedadam"
CPU_ADAM_OPTIMIZER = "cpuadam"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
COMM_BACKEND_NAME = "comm_backend_name"

FP16 = "fp16"
BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"

GRADIENT_CLIPPING = "gradient_clipping"
ZERO_OPTIMIZATION = "zero_optimization"

CHECKPOINT = "checkpoint"
LOAD_UNIVERSAL_CHECKPOINT = "load_universal"

SEED = "seed"
DATALOADER_DROP_LAST = "dataloader_drop_last"

PIPELINE = "pipeline"
PIPELINE_PARALLEL_SIZE = "pipeline_parallel_size"
TENSOR_PARALLEL = "tensor_parallel"
SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
EXPERT_PARALLEL_SIZE = "expert_parallel_size"

COMMS_LOGGER = "comms_logger"
FLOPS_PROFILER = "flops_profiler"
MONITOR_CSV = "csv_monitor"
MONITOR_TENSORBOARD = "tensorboard"
MONITOR_WANDB = "wandb"
MONITOR_COMET = "comet"
MONITOR_JSONL = "jsonl_monitor"
TELEMETRY = "telemetry"
DATA_EFFICIENCY = "data_efficiency"
CURRICULUM_LEARNING_LEGACY = "curriculum_learning"
ELASTICITY = "elasticity"

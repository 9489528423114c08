"""The compressed wires (counterpart of ``deepspeed_tpu/runtime/comm``):
ZeRO++'s int8 collectives (`coalesced_collectives.py`) and the 1-bit
optimizers' sign-compressed all-reduce (`compressed.py`)."""

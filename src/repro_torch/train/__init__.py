"""Training: AdamW (float32 / bf16 / int8 state), int8 gradient compression
with error feedback, the train step with microbatch accumulation, atomic
checkpoints and the training loop.  The port of ``repro.train``."""

"""Training (``repro.train``): AdamW with fp32/bf16/int8 moments and the
train step with accumulation and int8 error-feedback gradient compression."""

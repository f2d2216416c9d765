"""Training (port of ``repro.train``): AdamW with clipping and a
warmup-cosine schedule, the train step with microbatch accumulation and
optional int8 gradient compression, checkpoints in the reference's
on-disk layout, and the elastic re-mesh decisions."""

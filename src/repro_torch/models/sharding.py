"""The logical-axis rule table of the JAX package's `models/sharding.py`:
logical axis -> mesh axes. The planner reads it to size what a mesh axis
shards (`planner._logical_factor`); the rest of that module, which places
tensors on a mesh, waits for tensor parallelism."""

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "d_inner": ("model",),
    "ssm_heads": ("model",),
    "lru": ("model",),
    # deliberately unsharded logical axes
    "layers": (), "seq": (), "d_model": (), "head_dim": (), "state": (),
    "conv": (), "pos3": (), "window": (), "chunk": (),
    # decode KV-cache sequence dim: unsharded by default
    "kv_seq": (),
    # the residual stream's sequence dim (sequence parallelism off)
    "seq_resid": (),
}

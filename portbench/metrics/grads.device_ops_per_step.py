"""Device operations of one worker's forward and backward: the profiler's
device operations that start inside the ``grads`` span (around
`repro_torch.train.train_step.per_worker_grads`), over the profiled
worker-steps.  A count that repeats from run to run."""
UNIT = "ops"
SPANS = {"grads": ["repro_torch.train.train_step:per_worker_grads"]}


def read(rec):
    p = rec["profile"]
    calls = p["span_calls"].get("grads", 0)
    if not calls or "grads" not in p["ops_in_span"]:
        return None
    return p["ops_in_span"]["grads"] / (calls * rec["rows"])

"""Milliseconds of one worker's forward and backward: a span around
`repro_torch.train.train_step.per_worker_grads`, closed by a device
synchronise, summed over the window and divided by the worker-steps
(calls times the worker rows the process runs)."""
UNIT = "ms"
SPANS = {"grads": ["repro_torch.train.train_step:per_worker_grads"]}


def read(rec):
    s = rec["spans"].get("grads", [])
    return 1e3 * sum(s) / (len(s) * rec["rows"]) if s else None

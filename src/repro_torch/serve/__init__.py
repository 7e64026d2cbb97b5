"""Serving: the continuous-batching `engine.ServeEngine` over the paged KV
cache in `kv_cache` (counterpart of `repro/serve/`).

Each engine step is one slot: it either prefills the newly admitted
requests in one batched forward (flash-attention forward kernel, k/v
written into the block pools) or advances every active lane by one token
(token k/v written, then the paged flash-decode kernel).  The offline
`serve_step.generate` path with its rotating dense cache is not ported yet.
"""

"""Serving (counterpart of `repro/serve/`): the continuous-batching
`engine.ServeEngine` over the paged KV cache in `kv_cache`, and the
offline `serve_step.generate` over the rotating dense decode state.

Each engine step is one slot: it either prefills the newly admitted
requests in one batched forward (flash-attention forward kernel, k/v
written into the block pools) or advances every active lane by one token
(token k/v written, then the paged flash-decode kernel).  The engine
serves attention-only token models.

`serve_step.generate` prefills a batch of prompts (one batched forward
for attention-only token models, a per-token decode loop for every other
architecture: mamba, xLSTM, MoE, the audio and vision stubs) and then
decodes greedy or sampled tokens, the samples drawn as the JAX package
draws them (`core.prng.categorical`); its attention is the plain path.
"""

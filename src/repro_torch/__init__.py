"""PyTorch / CUDA port of the reproduction of "From Cooperative Scans to
Predictive Buffer Management", for NVIDIA Hopper.

The JAX package ``repro`` stays in the tree as the reference; this
package imports ``torch`` and ``numpy`` only — never ``jax``, never
anything of ``repro`` — and mirrors its layout so a reader finds the
counterpart of each module:

* ``repro_torch.core`` — storage model, scan operators, workloads, the
  policy registry, the event engine (the dict/heapq machine the simulator
  is held to) and ``array_sim``, the batched buffer-pool simulator (LRU /
  PBM / OPT / array-CScan in one call; fixed-dt and event-horizon
  steppers; ``validate`` against the event engine);
* ``repro_torch.serving`` — the paged-KV serving engine and its model;
* ``repro_torch.configs`` / ``repro_torch.models`` — the architecture
  configurations and the model stack's serving path (dense LM, Mamba2
  hybrid, xLSTM: ``build_model`` -> ``prefill_logits`` / ``serve_step``);
* ``repro_torch.kernels`` — the hand-written CUDA kernels of those paths,
  their plain PyTorch versions and the dispatch by tensor device.

Every entry point takes ``device`` (default ``"cuda"``) and raises on a
machine without a GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

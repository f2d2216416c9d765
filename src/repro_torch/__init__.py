"""PyTorch / CUDA port of the reproduction of "From Cooperative Scans to
Predictive Buffer Management", for NVIDIA Hopper.

The JAX package ``repro`` stays in the tree as the reference; this
package imports ``torch`` and ``numpy`` only — never ``jax``, never
anything of ``repro`` — and mirrors its layout so a reader finds the
counterpart of each module:

* ``repro_torch.core`` — storage model, scan specs, workloads, the policy
  registry (array side) and ``array_sim``, the batched buffer-pool
  simulator (LRU / PBM / OPT, event-horizon stepper);
* ``repro_torch.kernels`` — the hand-written CUDA kernels of the
  simulator's main path, their plain PyTorch versions and the dispatch by
  tensor device.

Every entry point takes ``device`` (default ``"cuda"``) and raises on a
machine without a GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

"""Checkpoint save / restore with async writes (port of
``repro.train.checkpoint``), in the reference's on-disk layout:

    <dir>/step_<N>/
      manifest.json        step, every flattened key's shape and dtype, extra
                           (the data streams' positions: exact resume)
      <flatkey>.npy        one file per param / optimizer leaf, ``/`` in the
                           key written ``__``; bf16 stored as f32

so a checkpoint written by either package restores in the other.  Keys are
the reference's ``_flatten`` of ``{"params": ..., "opt": OptState}``
(``opt/step``, ``opt/mu/...``, ``opt/nu/...``).

Fault-tolerance contract, as in the reference:

* save is atomic (write to a ``.tmp_step_<N>`` directory, then rename) — a
  crash mid-save never corrupts the latest checkpoint;
* ``async_=True`` copies every leaf to host memory before it returns (the
  caller may update its tensors in place at once) and writes in a thread,
  overlapping serialisation with the next step; ``wait`` (which the next
  save calls first) re-raises what the writer raised;
* ``keep`` bounds the steps kept on disk.

The reference's ``restore(shardings=...)`` places leaves on a mesh; on one
card ``restore`` places each leaf on its template leaf's device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (tuple, list)) or hasattr(tree, "_fields"):
        items = tree._asdict().items() if hasattr(tree, "_asdict") \
            else enumerate(tree)
        for k, v in items:
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    out[prefix] = tree
    return out


def _unflatten_like(template: Any, flat: Dict[str, Any],
                    prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {
            k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in template.items()
        }
    if hasattr(template, "_fields"):  # NamedTuple (OptState)
        vals = {
            k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in template._asdict().items()
        }
        return type(template)(**vals)
    if isinstance(template, (tuple, list)):
        return type(template)(
            _unflatten_like(v, flat, f"{prefix}/{i}")
            for i, v in enumerate(template))
    return flat[prefix]


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``str(np.asarray(x).dtype)`` in the
    reference): ``float32``, ``bfloat16``, ``int32``..."""
    return str(dtype).replace("torch.", "")


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that no later in-place update reaches; bf16
    as f32 (npy has no bf16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------------ save
    def save(
        self,
        step: int,
        params: Any,
        opt_state: Any = None,
        extra: Optional[Dict] = None,
        async_: bool = False,
    ) -> None:
        trees = {"params": params}
        if opt_state is not None:
            trees["opt"] = opt_state
        flat = _flatten(trees)
        arrays = {k: _host_copy(v) for k, v in flat.items()}
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(arrays[k].shape),
                         "dtype": _dtype_name(v.dtype)}
                     for k, v in flat.items()},
            "extra": extra or {},
        }

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for k, a in arrays.items():
                np.save(os.path.join(tmp, k.replace("/", "__") + ".npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)  # atomic publish
            self._gc()

        def write_in_thread():
            try:
                write()
            except Exception as e:          # handed to the caller by wait()
                self._error = e

        if async_:
            self.wait()
            self._thread = threading.Thread(target=write_in_thread,
                                            daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        """Block until the async write in flight (if any) is published;
        raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        step: Optional[int],
        params_template: Any,
        opt_template: Any = None,
    ) -> Tuple[int, Any, Any, Dict]:
        """``(step, params, opt_state, extra)``: new tensors in the
        templates' trees, dtypes and devices."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        def load_tree(template, prefix):
            loaded = {}
            for k, tmpl in _flatten({prefix: template}).items():
                a = np.load(os.path.join(d, k.replace("/", "__") + ".npy"))
                loaded[k] = torch.from_numpy(a).to(
                    device=tmpl.device, dtype=tmpl.dtype)   # bf16 restored
            return _unflatten_like({prefix: template}, loaded)[prefix]

        params = load_tree(params_template, "params")
        opt = (load_tree(opt_template, "opt") if opt_template is not None
               else None)
        return step, params, opt, manifest.get("extra", {})

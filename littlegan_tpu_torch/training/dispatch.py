"""K updates per host call: the port's counterpart of the one XLA dispatch
that littlegan_tpu/training/step.py::_make_scan_dispatch makes of K scanned
updates.

:class:`GraphedUpdates` wraps a ``body(inputs, device_inputs, *fixed)`` that
runs K updates from device tensors alone (``step.scan_updates``):

- ``inputs``: a (K, width) float32 array the host writes per call (the batch
  ids and the schedule rows), copied to the card in one copy;
- ``device_inputs``: tensors already on the card (the K updates' draws,
  drawn outside the graph so that K dispatched updates draw exactly what K
  sequential steps draw), copied into the graph's own buffers (a ``None``
  leaf, a draw the config does not make, stays ``None``);
- ``fixed``: what stays the same object from call to call (the train state,
  the device store). The state's tensors are updated in place, so they are
  the graph's own; a call with other tensors raises.

On a CUDA state the first call (or :meth:`GraphedUpdates.prepare`) runs the
K updates once eagerly on a side stream, so that every kernel, cuBLAS and
cuDNN handle and workspace meets its first use outside the capture, puts the
state back as it was (the warm-up applied real updates), and captures the K
updates, unrolled, in one CUDA graph on that stream. Every call then
replays it. A capture or a replay that fails raises: on a CUDA state the
updates never run eagerly in its place. On a CPU state the same body runs
eagerly, which is the path the tests take.

The kernel wrappers count their launches when they are called, and a
capture calls them once while the graph launches their kernels at every
replay: the capture's counts are taken back, and each replay adds the
launches the graph holds (``launches``).

While a profiler runs, each call's parts are ``littlegan:dispatch.*``
ranges (``utils/spans.py``): ``stage_wait`` (the previous call's staging
copy), ``stage`` (the pinned write and its copy), ``inputs`` (the copies
into the graph's device inputs), ``replay`` and ``outputs`` (the clones).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.utils.spans import span


class GraphedUpdates:
    def __init__(self, body: Callable):
        self.body = body
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}  # kernel launches per replay, by wrapper name
        self._inputs: Optional[torch.Tensor] = None  # the graph's (K, width) inputs
        self._host: Optional[torch.Tensor] = None  # pinned staging of the inputs
        self._copied: Optional[torch.cuda.Event] = None  # the last staging copy has run
        self._device_inputs: List[torch.Tensor] = []
        self._outputs = None
        self._ptrs: List[int] = []

    def prepare(self, inputs: np.ndarray, device_inputs, fixed: tuple, state_tensors: Sequence[torch.Tensor]):
        """Capture the graph unless it is captured, with ``inputs`` and
        ``device_inputs`` as the shapes (and first contents) of its buffers.
        The state is left as it was. Nothing to do on a CPU state."""
        if self.graph is not None or not state_tensors[0].is_cuda:
            return
        dev = state_tensors[0].device
        inputs = np.ascontiguousarray(inputs, np.float32)
        self._inputs = torch.from_numpy(inputs).to(dev)
        self._host = torch.empty(inputs.shape, dtype=torch.float32, pin_memory=True)
        leaves, spec = tree_flatten(device_inputs)
        self._device_inputs = [None if x is None else x.clone() for x in leaves]
        static = tree_unflatten(self._device_inputs, spec)
        saved = [t.detach().clone() for t in state_tensors]
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.body(self._inputs, static, *fixed)  # warm-up: first use of everything
            with torch.no_grad():
                for t, s in zip(state_tensors, saved):
                    t.copy_(s)
        torch.cuda.current_stream(dev).wait_stream(stream)
        del saved
        torch.cuda.synchronize(dev)  # the warm-up's work (collectives included) has finished before the capture
        torch.cuda.empty_cache()  # the warm-up's freed blocks back to the card: the capture takes a pool of its own
        before = _build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            outputs = self.body(self._inputs, static, *fixed)
        after = _build.launch_counts()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        for k, n in self.launches.items():  # the capture launched nothing; each replay will
            _build.COUNTERS[k].add(-n)
        self.graph, self._outputs = graph, outputs
        self._ptrs = self._pointers(fixed, state_tensors)
        self._copied = torch.cuda.Event()
        self._copied.record()

    @staticmethod
    def _pointers(fixed: tuple, state_tensors: Sequence[torch.Tensor]) -> List[int]:
        return [t.data_ptr() for t in list(state_tensors) + [x for x in fixed if isinstance(x, torch.Tensor)]]

    def __call__(self, inputs: np.ndarray, device_inputs, fixed: tuple, state_tensors: Sequence[torch.Tensor]):
        """Run the K updates: the body's outputs (clones on the card: the
        graph's own outputs are overwritten by its next replay)."""
        inputs = np.ascontiguousarray(inputs, np.float32)
        if not state_tensors[0].is_cuda:
            return self.body(torch.from_numpy(inputs), device_inputs, *fixed)
        self.prepare(inputs, device_inputs, fixed, state_tensors)
        if self._pointers(fixed, state_tensors) != self._ptrs:
            raise RuntimeError("GraphedUpdates: called with other state or store tensors than it captured")
        leaves, _ = tree_flatten(device_inputs)
        shapes = lambda xs: [None if x is None else x.shape for x in xs]  # noqa: E731
        if inputs.shape != tuple(self._inputs.shape) or shapes(leaves) != shapes(self._device_inputs):
            raise ValueError("GraphedUpdates: inputs of other shapes than the captured ones")
        with span("dispatch.stage_wait"):
            self._copied.synchronize()  # the previous call's copy out of the staging buffer has run
        with span("dispatch.stage"):
            self._host.numpy()[...] = inputs
            self._inputs.copy_(self._host, non_blocking=True)
            self._copied.record()
        with span("dispatch.inputs"):
            for static, x in zip(self._device_inputs, leaves):
                if static is not None:
                    static.copy_(x)
        with span("dispatch.replay"):
            self.graph.replay()
            for k, n in self.launches.items():
                _build.COUNTERS[k].add(n)
        with span("dispatch.outputs"):
            return tree_map(torch.clone, self._outputs)

"""volrend_torch: the PlenOctree display renderer and its whole-frame
trainer in PyTorch with hand-written CUDA kernels for NVIDIA Hopper (H100).

Same layout and function names as ``volrend_tpu`` (the reference
implementation it is held against by ``tests/test_torch_*.py``), with
PyTorch idiom inside: tensors on an explicit device, dataclasses of tensors,
explicit batch dimensions instead of ``vmap``/``lax.map``.

What runs where:

- plain tensor code (geometry, bake, finalize) runs on any torch device;
- the kernels (``csrc/*.cu``: the fused slab march in its display and
  training modes, its backward, the window-table build and the tent-combine
  emit) launch on CUDA tensors and raise on anything they do not take;
  each wrapper runs its plain PyTorch version only when handed CPU tensors
  (the tests' tier);
- entry points default to ``device="cuda"`` and raise when no card is
  present unless the caller asks for the CPU explicitly.
"""

__version__ = "0.1.0"

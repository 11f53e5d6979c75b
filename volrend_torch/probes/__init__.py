"""Measurement probes of the port: the counterparts of the reference's
``tools/perf_overlap.py``, ``tools/perf_sq3.py`` and ``tools/perf_sq4.py``,
each with its hand-written CUDA kernel (``csrc/probe_stream.cu``,
``csrc/probe_combine.cu``, ``csrc/probe_build.cu``), and two of the port's
own for kernel M's display mode.

No user path runs them. Each asks a question the kernel redesigns need
answered on the card:

- ``perf_overlap``: how far kernel M sits above a pure stream of its
  payload (``stream_probe``), its K sweep, and the full frame;
- ``perf_sq3``: the superquad warp with a planar gathered table and its own
  tent-combine kernel (``combine_probe``), against the production warp;
- ``perf_sq4``: the cost of the per-pose window-table build in five
  layouts (``build_probe`` is the build kernel of two of them);
- ``display_tiles``: kernel M's display launches at both tile heights,
  the evidence behind ``slab_march.display_config``'s tile rule;
- ``display_info`` and ``display_sass``: what the card makes of kernel M's
  display instantiations (blocks per SM, registers, spills), and whether
  the SH int8 defaults' machine code equals another checkout's;
- ``warp_fit``: kernel W's fit mode at a group, 4 poses, one and the
  steep pose, bit-equal to its plain version, in turns with a parent's
  build of ``csrc/warp_display.cu``;
- ``ndc_rows``: how far kernel W's NDC parameter rows
  (``display_warp.display_params_ndc``) place each pixel from a float64
  world2ndc, beside the float32 world2ndc chain they replaced (float
  errors: it runs on the CPU too);
- ``tma_box``: whether a one-box TMA load over the display payload works
  on the card (``csrc/probe_tma_box.cu``, built apart from the port's
  kernels).

Each runs as ``python -m volrend_torch.probes.<name>`` on a machine with a
card, at the reference probes' own width (``_common``).
"""

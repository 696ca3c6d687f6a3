"""The plain reference that decides ``correct``.

Plain PyTorch, frozen into the benchmark so that no later change to the
program moves the yardstick: the rasterizer (preprocess and SH colour,
tile binning with its per-tile cap K and per-Gaussian cap D, front-to-back
compositing), the losses of the train step, the reprojection z-buffer,
the DPT-Hybrid depth net, Adam and the opacity reset. Each module names
the program file it was copied from; the copies were taken from
``sdpgs_torch`` as it stood when the benchmark was written and are not
kept in step with it.

Nothing here imports ``sdpgs_torch``, ``sdpgs_tpu`` or JAX
(``benchmark/tests/test_harness_imports.py`` holds it to that), and
nothing here takes a tensor the program made: the benchmark hands both
sides the same inputs, and the reference works out again whatever the
program derives from them.
"""

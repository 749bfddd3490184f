"""gpuseqalign_tpu_torch — the PyTorch/CUDA port of gpuseqalign_tpu.

The same pairwise alignment framework (Needleman-Wunsch and Smith-Waterman,
linear and affine gaps, int32 DP bit-exact with the reference) for one
NVIDIA H100. The sparse (mlsp) tile-header fill runs as a hand-written CUDA
kernel; every other device step is plain PyTorch. The package imports
``torch`` and ``numpy`` only and keeps its own copies of the host modules.

Layer map (the same paths as gpuseqalign_tpu):
  io/        config & input parsing   (ref: cmd_parser/file_formats/io, L5)
  bench/     benchmark orchestrator   (ref: benchmark.cpp, L4)
  core/      registry, types, params  (ref: nw_algorithm/run_types, L3)
  models/    alignment problem specs + CPU oracles (ref: nwalign_cpu*, L2a)
  ops/       device fills: CUDA kernel + its plain PyTorch version (L2a)
  trace/     traceback / hash / print (ref: nwtrace*, L2b)
  utils/     stopwatch, device resolution          (ref: L1)
  native/    C++ host runtime (oracle DP, traceback, hashing) via ctypes

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

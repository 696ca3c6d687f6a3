"""setup_s: seconds from the process's start to the window's opening
(host clock): torch and CUDA start, the kernels' build or load, the scene,
weights and program objects made from the seed, the warm-up."""


def read(run):
    return run.setup_s

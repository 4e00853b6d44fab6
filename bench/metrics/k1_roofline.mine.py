"""K1: the bound of the traced jobs' packed chunk launches over the device time of the K1 kernels (torch.profiler)."""

from bench.readers import K1_KERNELS, k1_bound_s, kernel_s, share

UNIT = "%"


def read(run):
    bound = k1_bound_s(run)
    return None if bound is None else share(bound, kernel_s(run, K1_KERNELS))

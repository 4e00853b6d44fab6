"""K3: the bound of the traced jobs' dense passes over every split's rows, over the device time of support_count_kernel summed over the cards (torch.profiler)."""

from bench.readers import K3_KERNELS, k3_bound_s, kernel_s, share

UNIT = "%"


def read(run):
    bound = k3_bound_s(run)
    return None if bound is None else share(bound, kernel_s(run, K3_KERNELS))

"""K2: the bound of the traced batches over the device time of the rule_match kernels (torch.profiler)."""

from bench.readers import K2_KERNELS, k2_bound_s, kernel_s, share

UNIT = "%"


def read(run):
    bound = k2_bound_s(run)
    return None if bound is None else share(bound, kernel_s(run, K2_KERNELS))

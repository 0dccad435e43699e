"""Share of the traced time of the cluster kernel's launches that the least
time of what these inputs need takes (lib/work.py: the hits in and the
clusters out at the memory bandwidth, or the IoU tests at the float64
peak, the larger), in %."""

from pigobench.lib import work


def read(ctx):
    return work.roofline(ctx, "cluster_kernel")

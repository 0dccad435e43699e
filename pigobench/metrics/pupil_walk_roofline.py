"""Share of the traced time of the pupil_walk_kernel launches that the least time
of what these inputs need takes (lib/work.py: bytes at the memory
bandwidth or operations at the arithmetic peak, the larger), in %."""

from pigobench.lib import work


def read(ctx):
    return work.roofline(ctx, "pupil_walk_kernel")

"""Useful walks over attempted ones, in %: 100 times the program's counter
`post.faces` (eyed faces answered) over `post.slots` (face slots the post
stage walked) in the traced frames (lib/spans.py)."""

from pigobench.lib import spans


def read(ctx):
    return spans.share(ctx, "post.faces", "post.slots")

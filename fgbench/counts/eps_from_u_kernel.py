"""Bytes one launch of K2 (``eps_from_u_kernel<T, DOT, DELTA>``) must
move, values a voxel as PERF.md's kernel table bounds them: the dot mode
reads u (3) and p (6) and writes w (6): 15; the Delta mode also reads mu:
16; the no-dot mode reads u and writes w: 9.  The dot's partials, one
value a block, are left out."""
import re

ITEMSIZE = {"float": 4, "double": 8}


def bytes_moved(app):
    t, dot, delta = re.search(r"eps_from_u_kernel<([^>]*)>",
                              app["kernel"]).group(1).replace(" ",
                                                              "").split(",")
    values = 16 if delta == "true" else (15 if dot == "true" else 9)
    return values * app["voxels"] * ITEMSIZE[t]

"""Bytes one application of a G0 chain must move, for every chain wrapper
of ``spectral_kernels.calls`` without a count of its own (K3, K4 and
their batched forms): its real input field read once and its output
written once, 2 B C values a voxel (the chains' bound in PERF.md's kernel
table), whatever the passes move between them."""


def bytes_moved(app):
    return (2 * app["batch"] * app["components"] * app["voxels"]
            * app["itemsize"])

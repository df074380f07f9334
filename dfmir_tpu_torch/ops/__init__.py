"""Warps, integration, filters and Jacobians; ``warp_cuda`` holds the kernel."""

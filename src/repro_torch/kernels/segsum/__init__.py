"""Segmented OR for the edge engines and the segment sum: host layouts,
plain versions, CUDA kernels, and the public ops (:mod:`.ops`)."""

"""The bytes and 32-bit multiplies of one batch of each kind of traffic,
frozen: formulas of the shapes, following the port's algorithm as it
stood when the benchmark was written, so that a roofline share reads the
same work whatever kernels a later version runs."""

"""The harness of the port's benchmark, shared by every kind of
configuration: lookup by name, the run record, the device trace and
the spans' arithmetic, the peaks and model FLOPs, the seeded weights,
and the judgement of the compared numbers against their limits. It
imports nothing of the JAX package."""

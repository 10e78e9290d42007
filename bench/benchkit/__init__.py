"""The harness of the port's benchmark: lookup by name, the traffic
generator, the run record, the device trace, the peaks and the
comparison that decides ``correct``. It imports nothing of the JAX
package."""

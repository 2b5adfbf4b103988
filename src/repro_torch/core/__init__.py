"""The planning side of H2 in the port: the chip catalog, the auto-profiler
(analytic and measured on the card), the HeteroPP cost model, the
pipeline schedules and their simulator, the data-parallel and resharding
closed forms.  All but the measured profiler are copies of the JAX
package's modules at the same paths; ``profiler.measure_layer_profile``
times the port's own model and kernels.
"""

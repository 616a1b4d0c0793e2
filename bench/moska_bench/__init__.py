"""The benchmark's own code: traffic, weights, the closed loop, the plain
reference and the judge, the trace reading and the yardstick (peaks, model
FLOPs and the frozen kernel-work counts). It imports nothing of the JAX
package; of the port it imports only the system under test."""

"""The unified config tree and the nerfacto yaml loader (copies of the JAX
package's, so the port imports nothing of it)."""

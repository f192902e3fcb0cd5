"""Host-side front end pieces the port's synthesis entry point needs
(numpy and scipy copies of the JAX package's ``frontend`` modules)."""

"""Plain references of the routines, one module a routine, found by the
``routine`` of a configuration.  Plain PyTorch: nothing here imports the
program, JAX or the JAX package."""

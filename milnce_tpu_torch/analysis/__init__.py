"""Runtime analysis of the port (``lockrt``: the lock sanitizer the
serving modules create their locks through).  The JAX package's static
passes walk jaxprs and are not ported."""

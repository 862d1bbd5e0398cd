"""Float64 models of published algorithms that the port's ops are held to."""

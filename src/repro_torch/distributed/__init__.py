"""Device meshes for the port's serving layer."""

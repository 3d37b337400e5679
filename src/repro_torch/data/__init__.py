"""Host-side acoustic feature extraction."""

"""Host-side utilities: the PNG codec and the rays/s meter."""

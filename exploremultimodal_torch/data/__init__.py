"""Host-side data the serving path reads."""

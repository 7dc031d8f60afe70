"""Host-side data: the .pt interchange formats and image metadata."""

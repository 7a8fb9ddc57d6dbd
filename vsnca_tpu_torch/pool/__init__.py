"""Sample pools."""

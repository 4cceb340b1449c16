"""Model configurations: the reference's, copied as pure data."""

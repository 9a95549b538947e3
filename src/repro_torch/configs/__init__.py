"""Model configurations: copies of the reference's ``configs/`` (pure
Python, so copied rather than imported), with the registry pointing
into this package. Every field of every architecture equals the
reference's, full and smoke."""

"""Tree serialization: the framed, integrity-checked blob format of the
cold memory tier (``io``)."""

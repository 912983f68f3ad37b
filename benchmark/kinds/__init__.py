"""One module a kind of traffic, each with a ``Job`` (see ``harness``)."""

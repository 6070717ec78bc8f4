"""Model configurations of the port (the embedding slice: ``ssl_paper``)."""

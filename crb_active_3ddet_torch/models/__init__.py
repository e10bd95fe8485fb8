"""Model zoo of the port: the SECOND eval path so far."""

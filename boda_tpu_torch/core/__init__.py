"""Device selection and feature probes."""

"""Platform-free utilities: the port's copy of the pure-Python LMDB
reader and writer."""

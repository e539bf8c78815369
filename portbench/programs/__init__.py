"""FHE programs that program traffic compiles, one a file."""

"""One module a kind of traffic (a traffic file's "op"): it sets up the
system under test for a cell, runs one batch of its requests, and checks
the outputs it kept against the plain reference."""

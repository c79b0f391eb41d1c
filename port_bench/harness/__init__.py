"""The benchmark's harness: one driver a kind of traffic (serve, train),
the seeded weights and traffic, the span wrappers and the trace reader."""

"""What the benchmark measures with: weights and inputs from the seed, the
card's peaks, operation and byte counts, and the reduction of traces."""

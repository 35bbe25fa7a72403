"""The plain float32 references the benchmark judges outputs by."""

"""Work counted from shapes on the reference: FLOPs and scan bytes."""

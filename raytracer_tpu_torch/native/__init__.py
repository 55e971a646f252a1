"""Host-side native code of the port (the C++ BVH builder)."""

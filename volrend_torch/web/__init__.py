"""The interactive viewer's HTTP server (server-side CUDA rendering)."""

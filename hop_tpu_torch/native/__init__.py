"""Native (C++) host-side components, bound through ctypes and built with
g++ at first use into `build/native/` at the repository root (listed in
.gitignore), never into the package."""

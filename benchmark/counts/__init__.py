"""The yardstick's arithmetic: model FLOPs by unit of work, each kernel's
operations and bytes, the launch shapes of each path, and the chip's
peaks."""

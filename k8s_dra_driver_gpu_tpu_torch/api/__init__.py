"""The opaque device-config API of the port's kubelet plugin
(``resource.nvidia.com/v1beta1``): its types and their decoders."""
